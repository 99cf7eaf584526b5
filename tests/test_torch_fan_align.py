"""The port's DECA aligner ``make_fan_align`` against the JAX package's on
the CPU, in both modes: SFD → 200·scale crop → FAN → kpt68 warp, and FAN
on the whole frame ("fan_frame").

Weights: a 2-module FAN with randomized batch-norm statistics and the
boosted S3FD of ``tests/torch_face_zoo.py`` (every face passes the gate,
so the kpt68 warp runs), through the JAX converters and back. Frames are
made with numpy from a seed.

Tolerance: aligned crops atol 1e-4 on [0, 1] values; the ok masks equal.
The landmarks inside must agree exactly for that to hold (FAN's argmax
cells are 4 px of the crop).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.pipeline.alignment import (
    make_fan_align as j_make_fan_align)

from stylegan_directions_face_reenactment_tpu_torch.pipeline.alignment import (
    DECA_CROP, make_fan_align)

from torch_face_zoo import fan_pair, s3fd_pair, statics_jit
from torch_threads import _threads  # noqa: F401

BOOST = "conv5_3_norm_mbox_conf"


@pytest.fixture(scope="module")
def nets():
    return {"fan": fan_pair(seed=21, num_modules=2),
            "boost": s3fd_pair(seed=22, boost_head=BOOST)}


@pytest.mark.parametrize("mode", ["sfd", "fan_frame"])
def test_make_fan_align_matches_jax(nets, mode):
    """The SFD → crop → FAN aligner (boosted net, so the kpt68 warp runs) and
    FAN on the whole frame, on 128² frames (resized to 256 for the nets,
    landmarks scaled back)."""
    jf, pf = nets["fan"]
    js, ps = nets["boost"] if mode == "sfd" else (None, None)
    imgs = np.random.RandomState(7).rand(2, 128, 128, 3).astype(np.float32)
    if mode == "sfd":
        want, want_ok = statics_jit(
            lambda f, s, im: j_make_fan_align(f, s, return_ok=True)(im), jf, js)(jnp.asarray(imgs))
    else:
        want, want_ok = statics_jit(
            lambda f, im: j_make_fan_align(f, return_ok=True)(im), jf)(jnp.asarray(imgs))
    with torch.no_grad():
        got, got_ok = make_fan_align(pf, ps, return_ok=True)(torch.from_numpy(imgs))
    assert got_ok.all() and got.shape == (2, DECA_CROP, DECA_CROP, 3)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
