"""The port's ``reenact_batch`` in "fan_frame" mode (FAN on the whole target
frame, no detector) against the JAX package on the CPU, in float32 and
bf16, and ``source_shape``. The set-up is ``tests/torch_reenact_world.py``;
the targets are 256² images in [-1, 1] made with numpy from a seed.

Tolerances, float32: coefficients rtol 1e-3, atol 1e-3·max; angles atol
1e-2 degrees; latents rtol 1e-4, atol 1e-4·max; images rtol 1e-3, atol
2e-4·max (the bounds of ``tests/test_torch_reenact.py``). bf16: FAN and the
DECA trunk run in bf16 in both packages but round in other places (and the
JAX synthesis promotes to f32 at its first noise add), so the limits are
mean relative drifts of about twice the readings: coefficients
0.0022-0.0052 (limit 0.011), angles 0.0102 (0.02), latents 0.0030 (0.006),
images 0.0140 (0.028).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.geometry.directions import (
    initialize_directions as j_initialize_directions)
from stylegan_directions_face_reenactment_tpu.pipeline.reenactment import (
    reenact_batch as j_reenact_batch, source_shape as j_source_shape)

from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
    reenact_batch, source_shape)

from torch_face_zoo import statics_jit
from torch_reenact_world import SIZE, T, build_world, close_scaled, mean_rel
from torch_threads import _threads  # noqa: F401


@pytest.fixture(scope="module")
def world():
    w = build_world()
    w["tgts"] = np.random.RandomState(10).uniform(-1, 1, (T, 256, 256, 3)).astype(np.float32)
    return w


def _run(world, dtype):
    g, a, deca, jf, _ = world["jax"]
    spec = j_initialize_directions("voxceleb", 15, 6.0)
    want = statics_jit(lambda g, a, deca, jf, c, p, an, tg: j_reenact_batch(
        g, a, deca, spec, c, p, an, tg, truncation=0.7,
        truncation_latent=jnp.asarray(world["trunc"]), fan_params=jf,
        compute_dtype=getattr(jnp, dtype), return_target_params=True),
        g, a, deca, jf)(world["code"], world["ps"], world["ang"], world["tgts"])
    want = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), want)
    pg, pa, pdeca, pf, _ = world["port"]
    t = torch.from_numpy
    with torch.no_grad():
        got = reenact_batch(
            pg, pa, pdeca, initialize_directions("voxceleb", 15, 6.0), t(world["code"]),
            {k: t(v) for k, v in world["ps"].items()}, t(world["ang"]), t(world["tgts"]),
            truncation=0.7, truncation_latent=t(world["trunc"]), fan_params=pf,
            compute_dtype=getattr(torch, dtype), return_target_params=True)
    return want, got


def test_fan_frame_matches_jax(world):
    (want_img, want_lat, want_p, want_a), (img, lat, pt, at) = _run(world, "float32")
    assert (at != -180.0).all()          # fan_frame never fails
    for k in want_p:
        close_scaled(pt[k].numpy(), want_p[k], 1e-3, 1e-3)
    np.testing.assert_allclose(at.numpy(), want_a, rtol=0, atol=1e-2)
    close_scaled(lat.numpy(), want_lat, 1e-4, 1e-4)
    close_scaled(img.numpy(), want_img, 1e-3, 2e-4)
    assert img.shape == (T, SIZE, SIZE, 3)


def test_fan_frame_bf16_matches_jax(world):
    (want_img, want_lat, want_p, want_a), (img, lat, pt, at) = _run(world, "bfloat16")
    assert img.dtype == torch.float32 and torch.isfinite(img).all()
    for k in want_p:
        assert pt[k].dtype == torch.float32
        assert mean_rel(pt[k], want_p[k]) < 0.011, k
    assert mean_rel(at, want_a) < 0.02
    assert mean_rel(lat, want_lat) < 0.006
    assert mean_rel(img, want_img) < 0.028


def test_source_shape_matches_jax(world):
    """The source's coefficients with the fan_frame alignment."""
    _, _, deca, jf, _ = world["jax"]
    _, _, pdeca, pf, _ = world["port"]
    src = world["tgts"][:1]
    want_p, want_a = statics_jit(lambda d, f, im: j_source_shape(d, im, f), deca, jf)(src)
    with torch.no_grad():
        got_p, got_a = source_shape(pdeca, torch.from_numpy(src), pf)
    for k in want_p:
        close_scaled(got_p[k].numpy(), np.asarray(want_p[k]), 1e-3, 1e-3)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=0, atol=1e-2)
