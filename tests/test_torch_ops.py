"""The port's ops (PyTorch, NCHW) against the JAX package's (NHWC) on the CPU.

Inputs are made with numpy from a seed and fed to both. K1 (upfirdn2d) and
K2 (fused bias-act) are held through their plain versions, which are what
the port runs for CPU tensors; the JAX side runs both its XLA form and its
Pallas kernel in interpret mode.

Tolerance: atol 1e-5 in float32 (rtol 1e-5 where values exceed 1): the two
frameworks sum the same products in another order.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.ops import (
    upfirdn2d as j_upfirdn2d, make_kernel as j_make_kernel,
    upsample2d as j_upsample2d, downsample2d as j_downsample2d, blur as j_blur,
    fused_leaky_relu as j_fused_leaky_relu, fused_leaky_relu_pallas,
    scaled_leaky_relu as j_scaled_leaky_relu, equal_linear as j_equal_linear,
    equal_conv2d as j_equal_conv2d, pixel_norm as j_pixel_norm,
    modulated_conv2d as j_modulated_conv2d, modulation_demod as j_demod)
from stylegan_directions_face_reenactment_tpu.ops.pallas_upfirdn import (
    upfirdn2d_pallas)

from stylegan_directions_face_reenactment_tpu_torch.ops import (
    upfirdn2d, make_kernel, upsample2d, downsample2d, blur, fused_leaky_relu,
    scaled_leaky_relu, equal_linear, equal_conv2d, pixel_norm,
    modulated_conv2d, modulation_demod)
from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
    fused_bias_act_cuda, fused_leaky_relu_plain)
from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
    upfirdn2d_cuda, upfirdn2d_fir)
from torch_threads import _threads  # noqa: F401

ATOL = 1e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=ATOL)


# ---------------------------------------------------------------------------
# K1: upfirdn2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("up,pad,taps,h,w,c", [
    (1, (1, 1), (1, 3, 3, 1), 17, 17, 8),    # blur after the transposed conv
    (2, (2, 1), (1, 3, 3, 1), 8, 8, 16),     # ToRGB skip upsample
    (1, (2, 2), (1, 3, 3, 1), 33, 33, 4),    # downsample pre-blur, odd size
    (2, (1, 2), (1, 3, 3, 1), 8, 12, 4),     # odd pads, non-square
    (2, (0, 0), (1, 2, 1), 7, 7, 4),         # k = 3, no pad
    (1, (-1, 2), (1, 3, 3, 1), 10, 10, 4),   # negative pad crops
])
def test_upfirdn2d_matches_jax_xla_and_pallas(up, pad, taps, h, w, c):
    rs = np.random.RandomState(0)
    x = rs.randn(2, h, w, c).astype(np.float32)
    k = make_kernel(taps, gain=up ** 2)
    jk = j_make_kernel(taps, gain=up ** 2)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    got = nhwc(upfirdn2d(nchw(x), k, up=up, down=1, pad=pad))
    want_xla = j_upfirdn2d(jnp.asarray(x), jk, up=up, down=1, pad=pad)
    assert got.shape == want_xla.shape
    close(got, want_xla)
    want_pallas = upfirdn2d_pallas(jnp.asarray(x), np.asarray(jk), up, pad)
    close(got, want_pallas)


@pytest.mark.parametrize("up,down,pad", [
    (1, 2, (1, 1)), (2, 2, (1, 2, 0, 3)), ((2, 1), (1, 2), (2, 1, 0, 1)),
])
def test_upfirdn2d_general_matches_jax(up, down, pad):
    rs = np.random.RandomState(1)
    x = rs.randn(1, 9, 11, 3).astype(np.float32)
    k = rs.rand(4, 3).astype(np.float32)
    got = nhwc(upfirdn2d(nchw(x), torch.from_numpy(k), up=up, down=down, pad=pad))
    want = j_upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down, pad=pad)
    close(got, want)


def test_resample_wrappers_match_jax_pallas_backend():
    """The generator's wrappers against the JAX package with its resample
    backend on "pallas" (the Pallas kernel, interpreted)."""
    rs = np.random.RandomState(2)
    x = rs.randn(2, 8, 8, 6).astype(np.float32)
    k_up = make_kernel((1, 3, 3, 1), gain=4)
    k_bl = make_kernel((1, 3, 3, 1))
    # the backend is the JAX package's global state: restore it whatever happens
    j_upfirdn_mod = importlib.import_module(
        "stylegan_directions_face_reenactment_tpu.ops.upfirdn2d")
    saved = j_upfirdn_mod._RESAMPLE_BACKEND
    try:
        j_upfirdn_mod.set_resample_backend("pallas")
        want_up = j_upsample2d(jnp.asarray(x), j_make_kernel((1, 3, 3, 1), gain=4))
        want_bl = j_blur(jnp.asarray(x), j_make_kernel((1, 3, 3, 1)), (1, 1))
    finally:
        j_upfirdn_mod.set_resample_backend(saved)
    close(nhwc(upsample2d(nchw(x), k_up)), want_up)
    close(nhwc(blur(nchw(x), k_bl, (1, 1))), want_bl)
    want_dn = j_downsample2d(jnp.asarray(x), j_make_kernel((1, 3, 3, 1)))
    close(nhwc(downsample2d(nchw(x), k_bl)), want_dn)


def test_kernel_wrappers_take_plain_version_on_cpu_only():
    """CPU tensors go through the plain versions and launch nothing; the
    CUDA launchers refuse CPU tensors instead of falling back."""
    x = torch.randn(1, 2, 5, 5)
    k = make_kernel((1, 3, 3, 1), gain=4)
    upfirdn2d_cuda.launches = 0
    fused_bias_act_cuda.launches = 0
    torch.testing.assert_close(upfirdn2d_fir(x, k, 2, (2, 1)),
                               upfirdn2d(x, k, up=2, pad=(2, 1)), rtol=0, atol=0)
    fused_leaky_relu(x, torch.zeros(2))
    assert upfirdn2d_cuda.launches == 0 and fused_bias_act_cuda.launches == 0
    with pytest.raises(ValueError):
        upfirdn2d_cuda(x, k, 2, (2, 1))
    with pytest.raises(ValueError):
        fused_bias_act_cuda(x, torch.zeros(2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upfirdn2d_plain_keeps_dtype(dtype):
    x = torch.randn(1, 2, 6, 6).to(dtype)
    y = upsample2d(x, make_kernel((1, 3, 3, 1), gain=4))
    assert y.dtype == dtype and y.shape == (1, 2, 12, 12)
    want = upsample2d(x.float(), make_kernel((1, 3, 3, 1), gain=4)).to(dtype)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K2: fused bias + leaky relu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 512), (2, 5, 5, 16), (3, 4, 4, 3)])
def test_fused_leaky_relu_matches_jax_pallas(shape):
    rs = np.random.RandomState(3)
    x = rs.randn(*shape).astype(np.float32)
    b = rs.randn(shape[-1]).astype(np.float32)
    want = fused_leaky_relu_pallas(jnp.asarray(x), jnp.asarray(b))
    want_jnp = j_fused_leaky_relu(jnp.asarray(x), jnp.asarray(b))
    if len(shape) == 4:
        got = nhwc(fused_leaky_relu(nchw(x), torch.from_numpy(b)))
    else:
        got = fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    close(got, want)
    close(got, want_jnp)


def test_fused_leaky_relu_plain_bf16_rounds_once():
    x = torch.randn(2, 8, 4, 4).to(torch.bfloat16)
    b = torch.randn(8)
    got = fused_leaky_relu_plain(x, b)
    v = x.float() + b.to(torch.bfloat16).float()[None, :, None, None]
    want = (torch.where(v >= 0, v, v * 0.2) * 2 ** 0.5).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_scaled_leaky_relu_matches_jax():
    x = np.random.RandomState(4).randn(3, 7).astype(np.float32)
    close(scaled_leaky_relu(torch.from_numpy(x)).numpy(),
          j_scaled_leaky_relu(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# Equalized ops and the modulated conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("activation,lr_mul", [(False, 1.0), (True, 0.01)])
def test_equal_linear_matches_jax(activation, lr_mul):
    rs = np.random.RandomState(5)
    x = rs.randn(4, 64).astype(np.float32)
    w = rs.randn(32, 64).astype(np.float32)
    b = rs.randn(32).astype(np.float32)
    got = equal_linear(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), lr_mul=lr_mul, activation=activation)
    want = j_equal_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          lr_mul=lr_mul, activation=activation)
    close(got.numpy(), want)


def test_equal_conv2d_and_pixel_norm_match_jax():
    rs = np.random.RandomState(6)
    x = rs.randn(2, 9, 9, 8).astype(np.float32)
    w = rs.randn(3, 3, 8, 4).astype(np.float32)            # HWIO
    b = rs.randn(4).astype(np.float32)
    got = equal_conv2d(nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                       torch.from_numpy(b), stride=2, padding=1)
    want = j_equal_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          stride=2, padding=1)
    close(nhwc(got), want)
    z = rs.randn(4, 512).astype(np.float32)
    close(pixel_norm(torch.from_numpy(z)).numpy(), j_pixel_norm(jnp.asarray(z)))


@pytest.mark.parametrize("k,cin,cout,demodulate,upsample,downsample", [
    (3, 16, 8, True, False, False),     # StyledConv
    (3, 16, 8, True, True, False),      # upsampling StyledConv
    (1, 16, 3, False, False, False),    # ToRGB: 1x1, no demod
    (3, 8, 8, True, False, True),       # downsampling
])
def test_modulated_conv2d_matches_jax(k, cin, cout, demodulate, upsample,
                                      downsample):
    rs = np.random.RandomState(7)
    x = rs.randn(2, 8, 8, cin).astype(np.float32)
    w = rs.randn(k, k, cin, cout).astype(np.float32)        # HWIO
    s = (rs.randn(2, cin) * 0.5 + 1.0).astype(np.float32)
    w_t = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())  # (out, in, kh, kw)
    got = modulated_conv2d(nchw(x), w_t, torch.from_numpy(s),
                           demodulate=demodulate, upsample=upsample,
                           downsample=downsample)
    want = j_modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                              demodulate=demodulate, upsample=upsample,
                              downsample=downsample)
    assert nhwc(got).shape == want.shape
    close(nhwc(got), want)
    if demodulate:
        close(modulation_demod(w_t, torch.from_numpy(s)).numpy(),
              j_demod(jnp.asarray(w), jnp.asarray(s)))
