"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card, at the serving path's shapes (voxceleb-256, channel
multiplier 1, a batch of 16), in float32 and bf16.

These need a CUDA card and nvcc; they are marked ``cuda`` and skip
elsewhere (the fixture decides, so every worker collects the same tests).
Run them on the card with:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest

(``--noconftest``: ``tests/conftest.py`` sets JAX up, and a machine for
the port need not have JAX.)

Tolerances: float32 atol 1e-5 (the sums run in another order than
cuDNN's); bf16 1e-2 relative to max(1, max|plain|) (one bf16 rounding,
2^-8, on either side).
"""

import pytest
import torch

from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
    fused_bias_act_cuda, fused_leaky_relu, fused_leaky_relu_plain)
from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
    fused_bias_act_calls, upfirdn2d_calls)
from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import (
    make_kernel, upfirdn2d)
from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
    upfirdn2d_cuda, upfirdn2d_fir)

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def check(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.float32:
        assert err <= 1e-5, err
    else:
        assert err <= 1e-2 * max(1.0, float(want.float().abs().max())), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("call", upfirdn2d_calls(), ids=lambda c: c.name)
def test_upfirdn2d_kernel_matches_plain(card, call, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(call.shape, generator=g, device=card).to(dtype)
    k = make_kernel((1, 3, 3, 1), gain=4)
    before = upfirdn2d_cuda.launches
    got = upfirdn2d_fir(x, k, call.up, call.pad)
    assert upfirdn2d_cuda.launches == before + 1
    check(got, upfirdn2d(x, k, up=call.up, pad=call.pad))
    torch.cuda.synchronize()


@pytest.mark.parametrize("up,pad,taps", [(1, (2, 2), (1, 3, 3, 1)),
                                         (2, (1, 2), (1, 2, 1)),
                                         (1, (-1, 2), (1, 3, 3, 1))])
def test_upfirdn2d_kernel_odd_pads(card, up, pad, taps):
    x = torch.randn(2, 5, 13, 11, device=card)
    k = make_kernel(taps, gain=up ** 2)
    check(upfirdn2d_cuda(x, k, up, pad), upfirdn2d(x, k, up=up, pad=pad))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", sorted(set(fused_bias_act_calls()))
                         + [(16, 512), (4096, 512), (3, 5, 7, 3)], ids=str)
def test_fused_bias_act_kernel_matches_plain(card, shape, dtype):
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    b = torch.randn(shape[1], generator=g, device=card)
    before = fused_bias_act_cuda.launches
    got = fused_leaky_relu(x, b)
    assert fused_bias_act_cuda.launches == before + 1
    check(got, fused_leaky_relu_plain(x, b))
    torch.cuda.synchronize()


def test_kernels_refuse_what_they_do_not_take(card):
    x = torch.randn(1, 2, 8, 8, device=card)
    k = make_kernel((1, 3, 3, 1), gain=4)
    with pytest.raises(ValueError):
        upfirdn2d_cuda(x, k, 3, (1, 1))
    with pytest.raises(ValueError):
        upfirdn2d_cuda(x, make_kernel((1, 2, 3, 3, 2, 1)), 1, (1, 1))
    with pytest.raises(ValueError):
        upfirdn2d_cuda(x.transpose(2, 3), k, 1, (1, 1))
    with pytest.raises(TypeError):
        fused_bias_act_cuda(x.half(), torch.zeros(2, device=card))
    with pytest.raises(NotImplementedError):
        y = upfirdn2d_fir(x.requires_grad_(), k, 2, (2, 1))
        y.sum().backward()
