"""StyleGAN3's filtered leaky ReLU in plain PyTorch, as NVlabs' reference
``torch_utils/ops/filtered_lrelu.py::_filtered_lrelu_ref`` composes it:
bias → upfirdn2d (up, pad, gain up²) → leaky ReLU, gain, clamp → upfirdn2d
(down), with ``_upfirdn2d_ref``'s arithmetic: zero-stuff, pad (negative pads
crop), the flipped 1-D filter as two depthwise convolutions (x then y), keep
every ``down``-th sample. float32.

The two depthwise convolutions of each filter run inside ``fir_context()``
(a no-op): a counter of the model's matrix and convolution FLOPs swaps it
for a context that hides them, so that no zero-stuffed tap is counted."""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

fir_context = contextlib.nullcontext


def upfirdn2d_ref(x: torch.Tensor, f: Optional[torch.Tensor], up: int = 1, down: int = 1,
                  padding=(0, 0, 0, 0), gain: float = 1.0) -> torch.Tensor:
    """NVlabs' ``_upfirdn2d_ref`` for a 1-D (separable) filter ``f`` or None."""
    if f is None:
        f = torch.ones(1, dtype=torch.float32, device=x.device)
    n, c, h, w = x.shape
    px0, px1, py0, py1 = padding
    x = x.reshape(n, c, h, 1, w, 1)
    x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
    x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0), max(-px0, 0): x.shape[3] - max(-px1, 0)]
    f = (f * (gain ** 0.5)).to(x.dtype).flip(0)
    f = f[None, None].repeat(c, 1, 1)
    with fir_context():
        x = F.conv2d(x, f.unsqueeze(2), groups=c)
        x = F.conv2d(x, f.unsqueeze(3), groups=c)
    return x[:, :, ::down, ::down]


def filtered_lrelu_ref(x: torch.Tensor, fu: Optional[torch.Tensor] = None,
                       fd: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None,
                       up: int = 1, down: int = 1, padding=(0, 0, 0, 0),
                       gain: float = float(np.sqrt(2)), slope: float = 0.2,
                       clamp: Optional[float] = None) -> torch.Tensor:
    if b is not None:
        x = x + b.reshape(1, -1, 1, 1)
    x = upfirdn2d_ref(x, fu, up=up, padding=padding, gain=up ** 2)
    x = F.leaky_relu(x, slope) * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return upfirdn2d_ref(x, fd, down=down)
