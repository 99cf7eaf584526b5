"""Shared NN primitives for the frozen nets (NCHW, inference mode).

What the serving path calls: the DECA ResNet-50 and its MLP head, the
S3FD and FAN face nets, and the separable warps of the face alignment;
source set-up adds the e4e encoder's IR-SE blocks (PReLU, sigmoid gates,
LeakyReLU heads, the align-corners upsample of its feature pyramid) and
LPIPS's AlexNet.
Batch norm is inference-mode, folded at call time. Conv weights are OIHW;
linear weights (out, in). Weights are cast to the input's dtype at use, so
a bf16 input runs the net in bf16.

The warps (:func:`warp_from_coords`, :func:`scale_translate_warp`) take
NHWC images like the JAX package's, since they resample whole frames of 3
channels: two dense f32 contractions, with TF32 off for them whatever the
global setting (the JAX package asks for f32 precision there too). So do
the gathers of the DECA renderer (:func:`grid_sample`, :func:`affine_warp`):
bilinear with zero padding, every tap outside the image reading 0.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """x (N, C, H, W), w (out, in, kh, kw)."""
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) @ w(out, in)^T + b."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def fold_bn(bn: nn.BatchNorm2d, dtype: torch.dtype,
            eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bn``'s weight, bias and running statistics folded in float32 to one
    scale and one shift per channel, each rounded to ``dtype`` (a norm
    without affine terms scales by 1 and shifts by 0)."""
    inv = torch.rsqrt(bn.running_var.float() + eps)
    if bn.weight is not None:
        inv = inv * bn.weight.float()
    shift = -bn.running_mean.float() * inv
    if bn.bias is not None:
        shift = shift + bn.bias.float()
    return inv.to(dtype), shift.to(dtype)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm on dim 1: ``x * inv + shift`` in x's dtype with
    the folds of :func:`fold_bn`."""
    inv, shift = fold_bn(bn, x.dtype, eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * inv.reshape(shape) + shift.reshape(shape)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Per-channel PReLU on dim 1; ``a`` holds one slope a channel."""
    return torch.where(x >= 0, x, x * a.to(x.dtype).reshape((1, -1) + (1,) * (x.dim() - 2)))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def max_pool2d(x: torch.Tensor, window: int, stride: Optional[int] = None,
               padding: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, window, stride or window, padding)


def avg_pool2d(x: torch.Tensor, window: int, stride: Optional[int] = None,
               padding: int = 0) -> torch.Tensor:
    """Average over the in-bounds elements of each window (padding is not
    counted), as the JAX package's reduce-window pair does."""
    return F.avg_pool2d(x, window, stride or window, padding,
                        count_include_pad=False)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Repeat every pixel ``factor`` times along H and W (NCHW)."""
    n, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(n, c, h, factor, w, factor)
    return x.reshape(n, c, h * factor, w * factor)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    return F.adaptive_avg_pool2d(x, out_hw)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW batch without antialiasing: half-pixel
    centres (the JAX package's ``jax.image.resize(..., antialias=False)``),
    or with ``align_corners`` the corner samples kept (samples at
    ``linspace(0, n - 1, out)``, clamped at the border)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners, antialias=False)


@contextlib.contextmanager
def full_f32_matmul():
    """float32 matrix products without TF32 inside the block (restored
    after it)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def tent_matrix(coords: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear interpolation matrix W[b, i, j] = max(0, 1 - |coords[b, i] -
    j|): row i samples source position coords[b, i] with zero padding (rows
    of out-of-range positions are all zero)."""
    j = torch.arange(size, dtype=torch.float32, device=coords.device)
    return torch.clamp_min(1.0 - (coords[..., None] - j).abs(), 0.0)


def warp_from_coords(images: torch.Tensor, src_y: torch.Tensor,
                     src_x: torch.Tensor) -> torch.Tensor:
    """Separable bilinear resample at per-sample axis coordinates (zero
    padding outside the image) as two float32 contractions.

    images: (B, H, W, C); src_y (B, oh), src_x (B, ow) in source pixels.
    Returns (B, oh, ow, C) float32.
    """
    h, w = images.shape[1], images.shape[2]
    wy = tent_matrix(src_y.float(), h)                     # (B, oh, H)
    wx = tent_matrix(src_x.float(), w)                     # (B, ow, W)
    with full_f32_matmul():
        tmp = torch.einsum("bih,bhwc->biwc", wy, images.float())
        return torch.einsum("bow,biwc->bioc", wx, tmp)


def scale_translate_warp(images: torch.Tensor, s: torch.Tensor,
                         tx: torch.Tensor, ty: torch.Tensor,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """Axis-aligned warp dst = s·src + t per sample, bilinear with zero
    padding. images: (B, H, W, C); s, tx, ty: (B,)."""
    oh, ow = out_hw
    dev = images.device
    dst_y = torch.arange(oh, dtype=torch.float32, device=dev)
    dst_x = torch.arange(ow, dtype=torch.float32, device=dev)
    src_y = (dst_y[None, :] - ty[:, None]) / s[:, None]   # (B, oh)
    src_x = (dst_x[None, :] - tx[:, None]) / s[:, None]   # (B, ow)
    return warp_from_coords(images, src_y, src_x)


def grid_sample(x: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False) -> torch.Tensor:
    """``F.grid_sample`` (bilinear, zero padding) on NHWC: x (N, H, W, C),
    grid (N, Hg, Wg, 2) of normalized (x, y) in [-1, 1] → (N, Hg, Wg, C)."""
    out = F.grid_sample(x.permute(0, 3, 1, 2), grid.to(x.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def affine_warp(x: torch.Tensor, theta: torch.Tensor,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """Warp an NHWC batch by per-sample affine maps from source to
    destination pixels (kornia's ``warp_affine``): output pixel p samples
    the source at theta⁻¹·p, bilinear with zero padding. theta (N, 2, 3) or
    (N, 3, 3)."""
    n = x.shape[0]
    oh, ow = out_hw
    theta = theta.to(device=x.device, dtype=torch.float32)
    if theta.shape[-2:] == (2, 3):
        bottom = theta.new_tensor([0.0, 0.0, 1.0]).expand(n, 1, 3)
        theta = torch.cat([theta, bottom], dim=1)
    inv = torch.linalg.inv(theta)
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=x.device),
                            torch.arange(ow, dtype=torch.float32, device=x.device),
                            indexing="ij")
    dst = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)        # (oh, ow, 3)
    with full_f32_matmul():
        src = torch.einsum("hwk,njk->nhwj", dst, inv)               # (N, oh, ow, 3)
    sx = src[..., 0] / src[..., 2]
    sy = src[..., 1] / src[..., 2]
    h, w = x.shape[1], x.shape[2]
    # pixel coordinates → grid_sample's normalized frame at align_corners=True
    grid = torch.stack([sx * (2.0 / max(w - 1, 1)) - 1.0,
                        sy * (2.0 / max(h - 1, 1)) - 1.0], dim=-1)
    return grid_sample(x, grid, align_corners=True)
