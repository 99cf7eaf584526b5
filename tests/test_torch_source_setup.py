"""The port's source set-up (``pipeline/source_setup.py::setup_source``)
against the JAX package's on the CPU: e4e inversion → PTI → source DECA.

The nets are those of ``tests/torch_reenact_world.py`` (a 64² generator,
DECA, a 2-module FAN and the boosted S3FD, whose faces all pass the 0.99
gate) plus the damped e4e of ``tests/test_torch_e4e.py`` (for a 64²
generator: 10 style heads on the 256 crop) and a seeded LPIPS. ``prep`` is
fixed: it returns a 256² crop in [-1, 1] made with numpy from a seed, with
``ok`` set, as the JAX package's ``skip_preprocess`` prep does after its
resize. The JAX side runs its own ``setup_source`` under one jit, with the
weights as arguments.

Tolerances: the source image exactly; the code rtol 1e-5, atol
5e-6·max|code| (the e4e bound of ``tests/test_torch_e4e.py``);
coefficients rtol 1e-3, atol 1e-3·max|coefficient| and angles atol 1e-2
degrees (the DECA bounds of ``tests/test_torch_reenact.py``); the tuned
generator's image of the JAX code rtol 1e-3, atol 2e-3·max|image| (two
Adam steps, whose first is near ±lr on every weight, so weights with
near-zero gradients step apart; read 6e-4·max).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.losses.lpips import convert_lpips_alex
from stylegan_directions_face_reenactment_tpu.pipeline.source_setup import (
    setup_source as j_setup_source)
from stylegan_directions_face_reenactment_tpu.pipeline.synthesis import (
    generate_image as j_generate_image)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_e4e_encoder)

from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
    CROP_SIZE, generate_image, setup_source)
from stylegan_directions_face_reenactment_tpu_torch.weights import (
    e4e_from_jax, init_lpips, lpips_from_jax)

from torch_face_zoo import damped_e4e, statics_jit, to_np
from torch_reenact_world import SIZE, build_world, close_scaled
from torch_threads import _threads  # noqa: F401

STEPS = 2


@pytest.fixture(scope="module")
def world():
    w = build_world()
    e = damped_e4e(7, SIZE)
    je = to_np(convert_e4e_encoder(e.state_dict(), image_resolution=SIZE))
    lp = init_lpips(8, device="cpu")
    jl = to_np(convert_lpips_alex(lp.net.layers.state_dict(), lp.lin.state_dict()))
    w["e4e"] = (je, e4e_from_jax(je, device="cpu"))
    w["lpips"] = (jl, lpips_from_jax(jl, device="cpu"))
    w["crop"] = np.random.RandomState(9).uniform(
        -1, 1, (CROP_SIZE, CROP_SIZE, 3)).astype(np.float32)
    return w


def prep(frames):
    """The one source frame as a batch of one (a numpy array for the port,
    a traced array for the JAX package), with ``ok`` set."""
    return frames[0][None], np.ones(1, bool)


@pytest.mark.parametrize("align", ["resize", "fan"])
def test_setup_source_matches_jax(world, align):
    """The resize alignment without PTI; the SFD → FAN alignment with
    ``STEPS`` PTI steps."""
    g, _, deca, jf, js = world["jax"]
    pg, _, pdeca, pf, ps = world["port"]
    fan = align == "fan"
    want = statics_jit(
        lambda g, e4e, deca, lp, jf, js, crop, trunc: j_setup_source(
            g, e4e, deca, [crop], prep, truncation_latent=trunc, optimize_generator=fan,
            lpips_params=lp, fan_params=jf if fan else None,
            s3fd_params=js if fan else None, opt_steps=STEPS),
        g, world["e4e"][0], deca, world["lpips"][0], jf, js)(world["crop"], world["trunc"])
    got = setup_source(
        pg, world["e4e"][1], pdeca, [world["crop"]], prep,
        truncation_latent=world["trunc"], optimize_generator=fan,
        lpips_params=world["lpips"][1], fan_params=pf if fan else None,
        s3fd_params=ps if fan else None, opt_steps=STEPS, device="cpu")
    img, code, g_src, p_src, ang = got
    w_img, w_code, w_g, w_p, w_ang = want
    np.testing.assert_array_equal(img.numpy(), np.asarray(w_img))
    assert code.shape == (1, 10, 512)
    close_scaled(code.numpy(), w_code, 1e-5, 5e-6)
    for k in w_p:
        close_scaled(p_src[k].numpy(), w_p[k], 1e-3, 1e-3)
    np.testing.assert_allclose(ang.numpy(), np.asarray(w_ang), rtol=0, atol=1e-2)
    if not fan:
        assert g_src is pg
        return
    assert g_src is not pg
    kw = dict(truncation=0.7, input_is_latent=True)
    want_img = j_generate_image(w_g, w_code, truncation_latent=jnp.asarray(world["trunc"]),
                                **kw)
    with torch.no_grad():
        got_img = generate_image(g_src, torch.tensor(np.asarray(w_code)),
                                 truncation_latent=torch.tensor(world["trunc"]), **kw)
    close_scaled(got_img.numpy(), want_img, 1e-3, 2e-3)
