"""Shared NN primitives for the frozen nets (NCHW, inference mode).

Only what the serving slice calls: the DECA ResNet-50 and its MLP head, and
the resize that stands in for the face-alignment warp. Batch norm is
inference-mode, folded at call time. Conv weights are OIHW; linear weights
(out, in). Weights are cast to the input's dtype at use, so a bf16 input
runs the net in bf16.
"""

from __future__ import annotations

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


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm on dim 1 from ``bn``'s weight, bias and running
    statistics, folded to one scale and one shift in float32."""
    inv = torch.rsqrt(bn.running_var.float() + eps) * bn.weight.float()
    shift = bn.bias.float() - bn.running_mean.float() * inv
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * inv.reshape(shape).to(x.dtype) + shift.reshape(shape).to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def max_pool2d(x: torch.Tensor, window: int, stride: Optional[int] = None,
               padding: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, window, stride or window, padding)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    return F.adaptive_avg_pool2d(x, out_hw)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW batch, half-pixel centres, without
    antialiasing (the JAX package's ``jax.image.resize(..., antialias=False)``)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=False)
