"""upfirdn2d at up 1 or 2, down 1, in plain PyTorch (``upfirdn2d.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .upfirdn2d import upfirdn2d

Taps = Tuple[Tuple[float, ...], Tuple[int, int]]


def taps_of(kernel) -> Taps:
    """The taps of ``kernel`` (a tensor, an array or a :data:`Taps` pair):
    their values row-major and their (kh, kw)."""
    if isinstance(kernel, tuple) and len(kernel) == 2 and isinstance(kernel[1], tuple):
        return kernel
    k = np.asarray(kernel.detach().cpu() if isinstance(kernel, torch.Tensor) else kernel,
                   np.float32)
    return tuple(float(v) for v in k.ravel()), (int(k.shape[0]), int(k.shape[1]))


def upfirdn2d_fir(x: torch.Tensor, kernel, up: int, pad: Tuple[int, ...]) -> torch.Tensor:
    values, shape = taps_of(kernel)
    k = torch.tensor(values, dtype=torch.float32).reshape(shape)
    return upfirdn2d(x, k, up=int(up), down=1, pad=tuple(int(p) for p in pad))
