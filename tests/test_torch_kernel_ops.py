"""The kernels as registered operators (``sdfr::*``) on the CPU.

``torch.library.opcheck`` on each of the five operators (K1, K1-bwd, K2,
K2-bwd, K3) at small shapes in float32 and bf16: the schema, the autograd
registration, the fake (shape-only) implementation against the real one,
and AOT dispatch. The fake implementation's shape and dtype equal the
plain version's; the public wrappers give the plain versions' values and,
through the operators' autograd formulas, the gradients of autograd
through the plain versions (float32: the backward identities are exact up
to summation order, rtol 1e-5, atol 1e-6·max). On the card the same
operators launch the kernels (``tests/test_torch_kernels_cuda.py``)."""

import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from stylegan_directions_face_reenactment_tpu_torch.ops import fused_conv_block as k3
from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
    fused_bias_act_bwd_op, fused_bias_act_op, fused_leaky_relu, fused_leaky_relu_plain)
from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import (
    blur, make_kernel, upfirdn2d, upsample2d)
from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
    taps_of, upfirdn2d_bwd_op, upfirdn2d_fir, upfirdn2d_op)
from torch_threads import _threads  # noqa: F401

DTYPES = [torch.float32, torch.bfloat16]
SQRT2 = math.sqrt(2.0)
TAPS, SHAPE = (list(t) for t in taps_of(make_kernel((1, 3, 3, 1), gain=4)))


def randn(*shape, seed=0, dtype=torch.float32):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)
                            ).to(dtype)


def k3_tensors(dtype, seed=1, c=256, grad=False):
    """x (1, 256, 4, 4) and a block's twelve K3Args tensors (random folds)."""
    rs = np.random.RandomState(seed)
    cin, cout = (256, 128, 64), (128, 64, 64)
    inv = [torch.from_numpy((1 + 0.1 * rs.randn(n)).astype(np.float32)) for n in cin]
    off = [torch.from_numpy((0.1 * rs.randn(n)).astype(np.float32)) for n in cin]
    w = [torch.from_numpy((rs.randn(o, i, 3, 3) / np.sqrt(9 * i)).astype(np.float32))
         for i, o in zip(cin, cout)]
    args = k3.make_k3_args(inv, off, w, dtype)
    x = randn(1, c, 4, 4, seed=seed + 1, dtype=dtype)
    if grad:
        x.requires_grad_()
        args = k3.K3Args(*(tuple(t.detach().requires_grad_() for t in part)
                           for part in args[:3]), args.wk)
    return x, args


def op_cases(dtype, grad):
    x1 = randn(2, 3, 8, 8, dtype=dtype).requires_grad_(grad)
    g1 = randn(2, 3, 16, 16, seed=2, dtype=dtype)
    x2 = randn(2, 4, 3, 3, seed=3, dtype=dtype).requires_grad_(grad)
    b2 = randn(4, seed=4).requires_grad_(grad)
    y2 = fused_leaky_relu_plain(x2.detach(), b2.detach())
    x3, a3 = k3_tensors(dtype, grad=grad)
    return {
        "upfirdn2d": (upfirdn2d_op, (x1, TAPS, SHAPE, 2, [2, 1])),
        "upfirdn2d_bwd": (upfirdn2d_bwd_op, (g1, TAPS, SHAPE, 2, [2, 1], [2, 3, 8, 8])),
        "fused_bias_act": (fused_bias_act_op, (x2, b2, 0.2, SQRT2)),
        "fused_bias_act_bwd": (fused_bias_act_bwd_op, (randn(2, 4, 3, 3, seed=5, dtype=dtype),
                                                       y2, 0.2, SQRT2)),
        "fused_conv_block": (k3.fused_conv_block_op, (x3,) + a3.inv + a3.off + a3.w + a3.wk),
    }


NAMES = ["upfirdn2d", "upfirdn2d_bwd", "fused_bias_act", "fused_bias_act_bwd",
         "fused_conv_block"]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_opcheck(name, dtype):
    """The forwards with inputs that need a gradient (their autograd
    formulas run under AOT dispatch), the backwards without."""
    op, args = op_cases(dtype, grad=not name.endswith("_bwd"))[name]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_fake_shapes_equal_the_plain_versions(name, dtype):
    op, args = op_cases(dtype, grad=False)[name]
    want = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        got = op(*fake_args)
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype == dtype


def test_wrappers_give_the_plain_values_and_gradients():
    k = make_kernel((1, 3, 3, 1), gain=4)
    for up, pad in ((2, (2, 1)), (1, (1, 1)), (1, (2, 2))):
        x = randn(2, 3, 9, 9, seed=up).requires_grad_()
        xr = x.detach().clone().requires_grad_()
        y = upfirdn2d_fir(x, k, up, pad)
        want = upfirdn2d(xr, k, up=up, pad=pad)
        torch.testing.assert_close(y, want, rtol=0, atol=0)
        g = randn(*y.shape, seed=7)
        y.backward(g)
        want.backward(g)
        torch.testing.assert_close(x.grad, xr.grad, rtol=1e-5, atol=1e-6)
    x = randn(2, 3, 8, 8, seed=8)
    torch.testing.assert_close(upsample2d(x, k), upsample2d(x, taps_of(k)), rtol=0, atol=0)
    torch.testing.assert_close(blur(x, make_kernel((1, 3, 3, 1)), (2, 2)),
                               upfirdn2d(x, make_kernel((1, 3, 3, 1)), pad=(2, 2)),
                               rtol=0, atol=0)
    for shape in ((4, 5), (2, 5, 3, 3)):
        x = randn(*shape, seed=9).requires_grad_()
        b = randn(shape[1], seed=10).requires_grad_()
        xr, br = (t.detach().clone().requires_grad_() for t in (x, b))
        y = fused_leaky_relu(x, b)
        v = xr + br.reshape((1, -1) + (1,) * (len(shape) - 2))
        want = torch.where(v >= 0, v, v * 0.2) * SQRT2
        torch.testing.assert_close(y, want, rtol=0, atol=0)
        g = randn(*shape, seed=11)
        y.backward(g)
        want.backward(g)
        torch.testing.assert_close(x.grad, xr.grad, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(b.grad, br.grad, rtol=1e-5, atol=1e-6)
    x, args = k3_tensors(torch.float32, grad=True)
    xr = x.detach().clone().requires_grad_()
    ar = k3.K3Args(*(tuple(t.detach().clone().requires_grad_() for t in part)
                     for part in args[:3]), args.wk)
    y = k3.fused_conv_block(x, args)
    want = k3.fused_conv_block_plain(xr, ar)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    g = randn(*y.shape, seed=12)
    y.backward(g)
    want.backward(g)
    for a, b in zip((x,) + args.inv + args.off + args.w, (xr,) + ar.inv + ar.off + ar.w):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6 * float(b.grad.abs().max()))


def test_operators_refuse_other_devices():
    """No implementation but the CPU's, the card's and the fake one: a
    tensor elsewhere raises (the wrappers say so first)."""
    meta = torch.empty(2, 3, 8, 8, device="meta")
    for fn in (lambda: upfirdn2d_fir(meta, make_kernel((1, 3, 3, 1)), 1, (1, 1)),
               lambda: fused_leaky_relu(meta, None)):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn()
    assert torch.ops.sdfr.upfirdn2d.default is not None
    assert {"upfirdn2d", "upfirdn2d_bwd", "fused_bias_act", "fused_bias_act_bwd",
            "fused_conv_block"} <= set(dir(torch.ops.sdfr))
