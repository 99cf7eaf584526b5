"""Equalized-learning-rate linear / conv primitives (StyleGAN2), NCHW.

Weights are stored at unit scale and multiplied by ``1/sqrt(fan_in)``
(times ``lr_mul``) at call time. Linear weights are (out, in); conv weights
are OIHW.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .fused_act import fused_leaky_relu


def equal_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 lr_mul: float = 1.0, activation: bool = False) -> torch.Tensor:
    """y = x @ (w * scale)^T (+ bias*lr_mul), scale = lr_mul / sqrt(in);
    with ``activation`` the bias goes into the fused activation (K2)."""
    scale = lr_mul / math.sqrt(weight.shape[1])
    out = F.linear(x, (weight * scale).to(x.dtype))
    if activation:
        return fused_leaky_relu(out, bias * lr_mul if bias is not None else None)
    if bias is not None:
        out = out + (bias * lr_mul).to(x.dtype)
    return out


def equal_conv2d(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Equalized conv; weight (out, in, kh, kw), scale = 1/sqrt(in*kh*kw)."""
    _, cin, kh, kw = weight.shape
    scale = 1.0 / math.sqrt(cin * kh * kw)
    b = bias.to(x.dtype) if bias is not None else None
    return F.conv2d(x, (weight * scale).to(x.dtype), b, stride=stride,
                    padding=padding)


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(mean(x^2 over the channel dim 1) + eps)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + eps)
