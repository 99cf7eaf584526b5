"""The port's PTI (``pipeline/pti.py::optimize_g``) against the JAX package
on the CPU.

A seeded 64² generator (channel multiplier 1) goes through the JAX
package's converter, with random noise weights and activation biases so
that every tuned parameter has a gradient; LPIPS likewise
(``tests/test_torch_lpips.py``). The pivot code, the truncation latent and
the real images (64² for the first step's gradients, 128² for the Adam
steps, so that they run the resize branch of a generator smaller than its
pivot) are made with numpy from a seed.

Tolerances:

* the first step's loss rtol 1e-5 and the gradients of the tuned
  parameters rtol 1e-3, atol 1e-4·max|gradient| of each tensor (read
  2e-5·max): the JAX package differentiates the same graph;
* the loss history over 2 steps rtol 1e-4 (read 1.3e-5): Adam's first
  step is close to ±lr on every weight, so a weight whose gradient is near
  zero can step the other way in the other framework, and the later losses
  drift apart more than the first;
* the tuned weights: within 2·steps·lr of the JAX package's (the largest
  such flip) and within 1e-3 of them in the mean.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.losses.lpips import convert_lpips_alex
from stylegan_directions_face_reenactment_tpu.losses.pti import pti_loss as j_pti_loss
from stylegan_directions_face_reenactment_tpu.models.stylegan2 import (
    mapping as j_mapping, n_latent_for)
from stylegan_directions_face_reenactment_tpu.pipeline.pti import (
    optimize_g as j_optimize_g, split_tunable as j_split_tunable)
from stylegan_directions_face_reenactment_tpu.pipeline.synthesis import (
    generate_image as j_generate_image)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_stylegan2_generator)

from stylegan_directions_face_reenactment_tpu_torch.pipeline.pti import (
    TUNED_CONV_RANGE, optimize_g, pti_objective, split_tunable)
from stylegan_directions_face_reenactment_tpu_torch.weights import (
    generator_from_jax, init_generator, init_lpips, lpips_from_jax)

from torch_face_zoo import statics_jit, to_np
from torch_threads import _threads  # noqa: F401

SIZE = 64
STEPS, LR = 2, 3e-3


@pytest.fixture(scope="module")
def world():
    sd = {k: (v[None] if k.endswith("conv.weight") else v) for k, v in
          init_generator(1, size=SIZE, channel_multiplier=1, device="cpu")
          .state_dict().items()}
    g = to_np(convert_stylegan2_generator(sd, size=SIZE, channel_multiplier=1))
    rs = np.random.RandomState(0)
    for c in [g["conv1"]] + g["convs"]:
        c["noise_weight"] = np.float32(rs.randn() * 0.5)
        c["act_bias"] = (0.1 * rs.randn(*c["act_bias"].shape)).astype(np.float32)
    lp = init_lpips(0, device="cpu")
    jl = to_np(convert_lpips_alex(lp.net.layers.state_dict(), lp.lin.state_dict()))
    z = rs.randn(32, 512).astype(np.float32)
    trunc = np.array(j_mapping(g, jnp.asarray(z)).mean(axis=0, keepdims=True))
    code = rs.randn(1, n_latent_for(SIZE), 512).astype(np.float32)
    real = rs.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    real128 = rs.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    return dict(jax=(g, jl), port=(generator_from_jax(g, device="cpu"),
                                   lpips_from_jax(jl, device="cpu")),
                trunc=trunc, code=code, real=real, real128=real128)


def _t(a):
    return torch.tensor(a)


def _port_run(world, real, steps):
    pg, plp = world["port"]
    return optimize_g(pg, _t(world["code"]), _t(real), plp, _t(world["trunc"]),
                      opt_steps=steps, lr=LR)


def _jax_run(world, real, steps):
    g, jl = world["jax"]
    fn = statics_jit(lambda g, jl, c, r, t: j_optimize_g(g, c, r, jl, t, opt_steps=steps,
                                                         lr=LR), g, jl)
    return fn(world["code"], real, world["trunc"])


def _tuned_pairs(port_g, jax_g):
    """(name, port tensor, JAX array in the port's layout) for each tuned
    parameter."""
    lo, hi = TUNED_CONV_RANGE
    for i in range(lo, min(hi, len(port_g.convs))):
        m, j = port_g.convs[i], jax_g["convs"][i]
        yield f"convs.{i}.conv.weight", m.conv.weight, np.transpose(
            np.asarray(j["conv"]["weight"]), (3, 2, 0, 1))
        yield f"convs.{i}.conv.modulation.weight", m.conv.modulation.weight, j["conv"]["mod"]["weight"]
        yield f"convs.{i}.conv.modulation.bias", m.conv.modulation.bias, j["conv"]["mod"]["bias"]
        yield f"convs.{i}.noise.weight", m.noise.weight, np.reshape(j["noise_weight"], (1,))
        yield f"convs.{i}.activate.bias", m.activate.bias, j["act_bias"]


def test_first_step_gradients_match_jax(world):
    g, jl = world["jax"]
    tunable, rebuild = j_split_tunable(g)

    def j_loss(t, g, jl, code, real, trunc):
        imgs = j_generate_image(j_split_tunable(g)[1](t), code, truncation=0.7,
                                truncation_latent=trunc, input_is_latent=True)
        return j_pti_loss(jl, imgs, real, pt_l2_lambda=100.0)[0]

    want_loss, want_grads = statics_jit(
        lambda g, jl, t, c, r, tr: jax.value_and_grad(j_loss)(t, g, jl, c, r, tr), g, jl)(
            tunable, world["code"], world["real"], world["trunc"])
    pg = copy.deepcopy(world["port"][0])
    pg.requires_grad_(False)
    for p in split_tunable(pg):
        p.requires_grad_(True)
    total, _, _ = pti_objective(pg, _t(world["code"]), _t(world["real"]), world["port"][1],
                                _t(world["trunc"]))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(want_loss), rtol=1e-5)
    tuned = set()
    grads = {"convs": [None] * TUNED_CONV_RANGE[0] + want_grads["convs"]}
    for name, p, want in _tuned_pairs(pg, grads):
        want = np.asarray(want)
        assert p.grad is not None and np.abs(want).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
        tuned.add(id(p))
    assert all(p.grad is None for p in pg.parameters() if id(p) not in tuned)


def test_optimize_g_matches_jax(world):
    """Two Adam steps against a pivot larger than the generator: its image
    is resized bilinearly to the pivot's size before the loss."""
    pg = world["port"][0]
    before = {k: v.clone() for k, v in pg.state_dict().items()}
    tuned, losses = _port_run(world, world["real128"], STEPS)
    want_g, want = _jax_run(world, world["real128"], STEPS)
    assert tuned is not pg and losses["loss_history"].shape == (STEPS,)
    np.testing.assert_allclose(losses["loss_history"].numpy(),
                               np.asarray(want["loss_history"]), rtol=1e-4)
    for k in ("loss", "l2_loss", "lpips_loss"):
        np.testing.assert_allclose(float(losses[k]), float(want[k]), rtol=1e-4, err_msg=k)
    # the caller's generator is untouched, bit for bit
    for k, v in pg.state_dict().items():
        assert torch.equal(v, before[k]), k
    # only convs[4..7] moved (all of them), each by at most about lr a step
    moved = set()
    for name, p, want_p in _tuned_pairs(tuned, to_np(want_g)):
        delta = (p - before[name]).abs()
        assert float(delta.max()) > 0 and float(delta.max()) <= STEPS * LR * 1.01, name
        diff = np.abs(p.numpy() - np.asarray(want_p))
        assert diff.max() <= 2 * STEPS * LR and diff.mean() <= 1e-3, name
        moved.add(name)
    for k, v in tuned.state_dict().items():
        if k not in moved:
            assert torch.equal(v, before[k]), k
    assert not any(p.requires_grad for p in tuned.parameters())
