"""The port's e4e inversion encoder against the JAX package on the CPU.

A seeded port encoder for a 64² generator (10 style heads) goes through the
JAX package's own checkpoint converter (``convert_e4e_encoder``) and back
into the port (``weights/from_jax.py::e4e_from_jax``), so the reference key
layout round-trips. Batch-norm statistics are randomized, and the scale of
each block's last batch norm is cut to 0.3: at the random init the 24
residual blocks grow the activations some 30,000-fold, which turns
last-digit differences into percent differences of the code (a trained
encoder's residual branches are damped too). Inputs are made with numpy
from a seed.

Tolerances: blocks rtol 1e-5, atol 1e-5·max|output| (3×3 convs of up to
4608 terms; read below 4e-6·max); the whole encoder rtol 1e-5, atol
5e-6·max|code| (read 2e-6·max).
"""

import numpy as np
import jax
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.models import irse as j_irse
from stylegan_directions_face_reenactment_tpu.models.e4e import (
    TAPS as J_TAPS, e4e_forward as j_e4e_forward)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_e4e_encoder)

from stylegan_directions_face_reenactment_tpu_torch.models import irse
from stylegan_directions_face_reenactment_tpu_torch.models.e4e import TAPS, e4e_forward
from stylegan_directions_face_reenactment_tpu_torch.weights import e4e_from_jax

from torch_face_zoo import damped_e4e, statics_jit, to_np
from torch_threads import _threads  # noqa: F401

RES = 64


@pytest.fixture(scope="module")
def pair():
    e = damped_e4e(0, RES)
    j = to_np(convert_e4e_encoder(e.state_dict(), image_resolution=RES))
    return e, j, e4e_from_jax(j, device="cpu")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def close(got, want, atol_rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol_rel * np.abs(want).max())


def test_state_dict_round_trips(pair):
    e, _, back = pair
    sd, sd_back = e.state_dict(), back.state_dict()
    assert set(sd) == set(sd_back)
    assert "styles.9.convs.10.weight" in sd and "body.3.shortcut_layer.1.running_var" in sd
    for k, v in sd.items():
        assert torch.equal(v, sd_back[k]), k


@pytest.mark.parametrize("block", [0, 1, 3], ids=["identity-stride2", "identity-stride1",
                                                  "conv-shortcut-stride2"])
def test_bottleneck_ir_matches_jax(pair, block):
    _, j, port = pair
    in_c, depth, stride = irse.IRSE50_BLOCKS[block]
    assert (in_c == depth) == (block != 3) and stride == (1 if block == 1 else 2)
    x = np.random.RandomState(block).randn(2, 16, 16, in_c).astype(np.float32)
    want = jax.jit(lambda a: j_irse.bottleneck_ir(j["body"][block], a))(x)
    with torch.no_grad():
        got = irse.bottleneck_ir(port.body[block], nchw(x))
    assert got.shape == (2, depth, 16 // stride, 16 // stride)
    close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)


def test_ir_body_taps_match_jax(pair):
    _, j, port = pair
    assert TAPS == J_TAPS
    x = np.random.RandomState(5).randn(1, 32, 32, 64).astype(np.float32)
    want_out, want_taps = statics_jit(
        lambda body, a: j_irse.ir_body(body, a, taps=J_TAPS), j["body"])(x)
    with torch.no_grad():
        out, taps = irse.ir_body(port.body, nchw(x), taps=TAPS)
    assert [tuple(t.shape) for t in taps] == [(1, 128, 8, 8), (1, 256, 4, 4), (1, 512, 2, 2)]
    for got, want in zip(taps + [out], list(want_taps) + [want_out]):
        close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)


def test_e4e_forward_matches_jax(pair):
    _, j, port = pair
    x = np.random.RandomState(6).uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    want = statics_jit(j_e4e_forward, j)(x)
    with torch.no_grad():
        got = e4e_forward(port, torch.from_numpy(x))
    assert got.shape == (2, 10, 512)
    close(got.numpy(), want, 5e-6)
