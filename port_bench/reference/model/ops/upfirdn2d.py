"""upfirdn2d — upsample, FIR filter, downsample — on NCHW tensors.

PyTorch counterpart of ``stylegan_directions_face_reenactment_tpu/ops/
upfirdn2d.py`` (which is NHWC). Semantics per spatial axis, those of the
reference's ``upfirdn2d_native``:

  1. zero-stuff the input by the integer factor ``up`` (each sample followed
     by ``up - 1`` zeros, so the length becomes ``in * up``);
  2. pad by ``(pad0, pad1)`` (negative values crop);
  3. convolve with the FIR kernel (a true convolution: the taps are flipped);
  4. keep every ``down``-th sample.

Output size: ``(in * up + pad0 + pad1 - k + down) // down``.

:func:`upfirdn2d` is the plain version, written exactly as those four steps,
for any tensor. :func:`upsample2d` and :func:`blur` are the generator's
resampling ops: they go through the hand-written CUDA kernel for CUDA tensors
and through the plain version for CPU tensors
(``ops/upfirdn2d_kernel.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Pad = Union[Tuple[int, int], Tuple[int, int, int, int]]


def kernel_array(k: Sequence[float], gain: float = 1.0) -> np.ndarray:
    """Normalized 2-D FIR kernel from a 1-D or 2-D tap list: the outer
    product of a 1-D taps vector, normalized to sum 1, times ``gain`` (such
    as ``factor**2`` for upsampling filters). A float32 numpy array."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / k.sum()
    return (k * gain).astype(np.float32)


def make_kernel(k: Sequence[float], gain: float = 1.0) -> torch.Tensor:
    """:func:`kernel_array` as a float32 CPU tensor."""
    return torch.from_numpy(kernel_array(k, gain))


def _normalize_updown(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def normalize_pad(pad: Pad) -> Tuple[int, int, int, int]:
    """(p0, p1) for both axes, or (px0, px1, py0, py1)."""
    if len(pad) == 2:
        p0, p1 = int(pad[0]), int(pad[1])
        return p0, p1, p0, p1
    px0, px1, py0, py1 = (int(p) for p in pad)
    return px0, px1, py0, py1


def upfirdn2d_output_shape(in_h: int, in_w: int, kernel_shape: Tuple[int, int],
                           up=1, down=1, pad: Pad = (0, 0)) -> Tuple[int, int]:
    up_x, up_y = _normalize_updown(up)
    down_x, down_y = _normalize_updown(down)
    px0, px1, py0, py1 = normalize_pad(pad)
    kh, kw = kernel_shape
    out_h = (in_h * up_y + py0 + py1 - kh + down_y) // down_y
    out_w = (in_w * up_x + px0 + px1 - kw + down_x) // down_x
    return out_h, out_w


def upfirdn2d(x: torch.Tensor, kernel, up=1, down=1,
              pad: Pad = (0, 0)) -> torch.Tensor:
    """Plain upsample → FIR → downsample of an NCHW batch.

    ``kernel``: (kh, kw) taps, not flipped (flipped here, so the op is a
    true convolution). ``up`` / ``down``: int or (x, y) factors. ``pad``:
    (p0, p1) on both axes or (px0, px1, py0, py1); negative values crop.
    Computes in float32 and returns ``x.dtype``.
    """
    up_x, up_y = _normalize_updown(up)
    down_x, down_y = _normalize_updown(down)
    px0, px1, py0, py1 = normalize_pad(pad)
    n, c, h, w = x.shape
    k = torch.as_tensor(kernel, dtype=torch.float32).to(x.device)
    kh, kw = k.shape

    out = x.float().reshape(n * c, 1, h, 1, w, 1)
    out = F.pad(out, (0, up_x - 1, 0, 0, 0, up_y - 1))
    out = out.reshape(n * c, 1, h * up_y, w * up_x)
    out = F.pad(out, (max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)))
    out = out[:, :, max(-py0, 0): out.shape[2] - max(-py1, 0),
              max(-px0, 0): out.shape[3] - max(-px1, 0)]
    out = F.conv2d(out, torch.flip(k, (0, 1)).view(1, 1, kh, kw))
    out = out[:, :, ::down_y, ::down_x]
    return out.reshape(n, c, out.shape[2], out.shape[3]).to(x.dtype)


# ---------------------------------------------------------------------------
# StyleGAN2 resampling wrappers (pad arithmetic of the reference model.py)
# ---------------------------------------------------------------------------

def upsample2d(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    """``factor``x upsampling with a FIR filter; ``kernel`` (a tensor, or
    taps as ``upfirdn2d_kernel.taps_of`` gives them) already holds the
    ``factor**2`` gain (:func:`make_kernel`)."""
    from .upfirdn2d_kernel import taps_of, upfirdn2d_fir
    kernel = taps_of(kernel)
    p = kernel[1][0] - factor
    return upfirdn2d_fir(x, kernel, factor, ((p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x: torch.Tensor, kernel: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """FIR filter then ``factor``x downsampling. Off the serving path: the
    JAX package runs it through XLA too, so it stays the plain version."""
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=1, down=factor, pad=((p + 1) // 2, p // 2))


def blur(x: torch.Tensor, kernel, pad: Tuple[int, int]) -> torch.Tensor:
    """FIR blur with an explicit pad (K1 at up 1): ``kernel`` a tensor, or
    taps as ``upfirdn2d_kernel.taps_of`` gives them."""
    from .upfirdn2d_kernel import upfirdn2d_fir
    return upfirdn2d_fir(x, kernel, 1, (int(pad[0]), int(pad[1])))
