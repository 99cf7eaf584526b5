"""StyleGAN2's fused bias + LeakyReLU + gain in plain PyTorch:

    y = leaky_relu(x + b[c], negative_slope) * scale

in float32, rounded once to ``x.dtype``; autograd differentiates it."""

from __future__ import annotations

import math
from typing import Optional

import torch

DEFAULT_SLOPE = 0.2
DEFAULT_SCALE = math.sqrt(2.0)


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = DEFAULT_SLOPE,
                     scale: float = DEFAULT_SCALE) -> torch.Tensor:
    v = x.float()
    if bias is not None:
        v = v + bias.to(x.dtype).float().reshape((1, -1) + (1,) * (x.dim() - 2))
    return (torch.where(v >= 0, v, v * negative_slope) * scale).to(x.dtype)


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = DEFAULT_SLOPE) -> torch.Tensor:
    return torch.where(x >= 0, x, x * negative_slope) * math.sqrt(2.0)
