"""The backward of K1 (upfirdn2d) and K2 (fused bias-act) against the JAX
package on the CPU: the plain versions that the CUDA kernels are held
against on the card.

* ``upfirdn2d_backward`` (the gradient identity: flipped taps, up and down
  swapped, the pads of ``grad_pad``) against ``jax.vjp`` of the JAX
  package's Pallas upfirdn2d (interpret mode on the CPU; its custom VJP is
  ``_backward``) and against torch autograd through the plain forward, for
  the generator's blur and ToRGB skip upsample and for pads that differ
  between the axes.
* ``fused_leaky_relu_bwd_plain`` and ``bias_grad`` against ``jax.vjp`` of
  the JAX package's Pallas fused bias-act (``_fused_bwd`` with
  ``_pallas_bwd_call``, interpret mode), in float32 and bf16, from the
  same saved output.

Tolerances: float32 rtol 1e-5, atol 1e-6·max (sums of at most 16 products,
read 0 to 5e-7); bf16 dx exact up to one bf16 rounding of the same f32
product (atol 2^-8·max), db relative 1e-2 (bf16 sums in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.ops.fused_act import (
    fused_leaky_relu_pallas)
from stylegan_directions_face_reenactment_tpu.ops.pallas_upfirdn import (
    upfirdn2d_pallas)
from stylegan_directions_face_reenactment_tpu.ops.upfirdn2d import (
    make_kernel as j_make_kernel)

from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
    bias_grad, fused_leaky_relu, fused_leaky_relu_bwd_plain, fused_leaky_relu_plain)
from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import (
    make_kernel, upfirdn2d)
from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
    grad_pad, upfirdn2d_backward, upfirdn2d_fir)
from torch_threads import _threads  # noqa: F401


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


# the generator's two resampling calls: (up, pad, gain, input H, W)
K1_CASES = {"blur": (1, (1, 1), 4, 17, 17), "skip": (2, (2, 1), 4, 8, 8)}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_upfirdn2d_backward_matches_jax_vjp(case):
    up, pad, gain, h, w = K1_CASES[case]
    rs = np.random.RandomState(1)
    x = rs.randn(2, h, w, 5).astype(np.float32)
    jk = j_make_kernel((1, 3, 3, 1), gain=gain)
    y, vjp = jax.vjp(lambda a: upfirdn2d_pallas(a, np.asarray(jk), up, pad), jnp.asarray(x))
    g = rs.randn(*y.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(g))
    got = upfirdn2d_backward(nchw(g), make_kernel((1, 3, 3, 1), gain=gain), up, pad,
                             (2, 5, h, w))
    assert got.shape == (2, 5, h, w)
    close(nhwc(got), want)


@pytest.mark.parametrize("up,pad", [(1, (1, 1)), (2, (2, 1)), (2, (2, 1, 1, 2)),
                                    (1, (2, 0, 1, 3))], ids=str)
def test_upfirdn2d_backward_is_autograd_of_plain(up, pad):
    """Against torch autograd through the plain forward (the CPU path of
    ``upfirdn2d_fir``), with pads that differ between the axes."""
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(1, 3, 9, 7).astype(np.float32)).requires_grad_()
    k = make_kernel((1, 3, 3, 1), gain=up * up)
    y = upfirdn2d_fir(x, k, up, pad) if len(pad) == 2 else upfirdn2d(x, k, up=up, pad=pad)
    g = torch.from_numpy(rs.randn(*y.shape).astype(np.float32))
    (want,) = torch.autograd.grad(y, x, g)
    close(upfirdn2d_backward(g, k, up, pad, x.shape).numpy(), want.numpy())


def test_grad_pad_of_the_generator_calls():
    assert grad_pad((4, 4), 1, (1, 1), (33, 33)) == (2, 2, 2, 2)
    assert grad_pad((4, 4), 2, (2, 1), (32, 32)) == (1, 1, 1, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 5, 16), (6, 32)], ids=str)
def test_fused_bias_act_bwd_matches_jax(shape, dtype):
    rs = np.random.RandomState(3)
    x = rs.randn(*shape).astype(np.float32)
    b = rs.randn(shape[-1]).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jy, vjp = jax.vjp(fused_leaky_relu_pallas, jnp.asarray(x, jdt), jnp.asarray(b, jdt))
    want_dx, want_db = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)

    def port(a):
        return nchw(a).to(tdt) if len(shape) == 4 else torch.tensor(a).to(tdt)

    # the saved output is JAX's: its bf16 forward rounds after the bias add
    # and again after the gain, the port's once, so the two y differ in bf16
    y = port(np.asarray(jy, np.float32))
    dx = fused_leaky_relu_bwd_plain(port(g), y)
    db = bias_grad(dx)
    assert dx.dtype == tdt and db.dtype == tdt
    to_np = nhwc if len(shape) == 4 else (lambda t: t.float().numpy())
    want_dx = np.asarray(want_dx, np.float32)
    if dtype == "float32":
        np.testing.assert_array_equal(
            to_np(fused_leaky_relu_plain(port(x), torch.from_numpy(b))), np.asarray(jy))
        close(to_np(dx), want_dx)
        close(db.numpy(), want_db)
    else:
        np.testing.assert_allclose(to_np(dx), want_dx, rtol=0,
                                   atol=2 ** -8 * np.abs(want_dx).max())
        want_db = np.asarray(want_db, np.float32)
        np.testing.assert_allclose(db.float().numpy(), want_db, rtol=0,
                                   atol=1e-2 * np.abs(want_db).max())


def test_fused_bias_act_bwd_is_autograd_of_plain():
    """The plain backward (mask from the saved output) is the gradient that
    autograd takes through the plain forward (mask from x + b)."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(2, 8, 4, 4).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(rs.randn(8).astype(np.float32)).requires_grad_()
    y = fused_leaky_relu(x, b)
    g = torch.from_numpy(rs.randn(*y.shape).astype(np.float32))
    want_dx, want_db = torch.autograd.grad(y, (x, b), g)
    dx = fused_leaky_relu_bwd_plain(g, y.detach())
    close(dx.numpy(), want_dx.numpy())
    close(bias_grad(dx).numpy(), want_db.numpy())
