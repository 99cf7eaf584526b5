"""Style-modulated convolution, the StyleGAN2 core op, NCHW.

The reference builds per-sample weights ``w' = scale * W * s_in``
(demodulated by ``rsqrt(sum w'^2)`` over (in, kh, kw)) and runs a grouped
conv with ``groups=batch``. Here, as in the JAX package, the algebraically
identical input/output scaling:

    conv(x, scale * W * s_in)[b, o]  ==  conv(x * s_in, scale * W)[b, o]

so there is one shared-weight ``F.conv2d`` (cuDNN) and the demod factor is
a per-(batch, out) scalar computed from ``W^2`` by one small matmul. Both
scalings commute with the blur FIR, so the up/downsample variants stay
exact:

  * upsample:   ``conv_transpose2d(stride=2)`` then blur (K1);
  * downsample: blur then stride-2 conv.

Weights are (out, in, kh, kw). The JAX HWIO weight, flipped and run with
``lhs_dilation``, is torch's ``conv_transpose2d`` with the unflipped
(in, out, kh, kw) weight.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .upfirdn2d import blur, kernel_array

DEFAULT_BLUR = (1, 3, 3, 1)


@functools.lru_cache(maxsize=None)
def _blur_taps(blur_kernel: Tuple[int, ...], gain: float):
    """The blur's taps as K1's operator takes them (values and shape), made
    once per (taps, gain) from numpy, so that no call converts a tensor
    and a traced program (``torch.export``) holds them as constants."""
    from .upfirdn2d_kernel import taps_of
    return taps_of(kernel_array(blur_kernel, gain=gain))


def modulation_demod(weight: torch.Tensor, style: torch.Tensor,
                     eps: float = 1e-8) -> torch.Tensor:
    """(B, out) float32: rsqrt(sum_{in,kh,kw} (scale*W*s)^2 + eps).

    weight: (out, in, kh, kw); style: (B, in) modulation scalars.
    """
    cout, cin, kh, kw = weight.shape
    scale = 1.0 / math.sqrt(cin * kh * kw)
    w2 = torch.square(weight.float() * scale).sum(dim=(2, 3)).t()   # (in, out)
    sigma = torch.square(style.float()) @ w2                        # (B, out)
    return torch.rsqrt(sigma + eps)


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, style: torch.Tensor,
                     *, demodulate: bool = True,
                     upsample: bool = False, downsample: bool = False,
                     blur_kernel: Sequence[int] = DEFAULT_BLUR,
                     eps: float = 1e-8) -> torch.Tensor:
    """Modulated conv over an NCHW batch.

    x: (B, in, H, W); weight: (out, in, kh, kw) at unit scale (the
    equalized-LR scale is applied here); style: (B, in), already through
    the style linear (whose bias initializes to 1).
    """
    cout, cin, kh, kw = weight.shape
    scale = 1.0 / math.sqrt(cin * kh * kw)
    demod = modulation_demod(weight, style, eps) if demodulate else None

    xm = x * style[:, :, None, None].to(x.dtype)
    w = (weight * scale).to(x.dtype)

    if upsample:
        factor = 2
        out = F.conv_transpose2d(xm, w.transpose(0, 1), stride=factor)
        # (H-1)*2 + kh rows; the blur brings them to 2H
        p = (len(blur_kernel) - factor) - (kh - 1)
        pad0 = (p + 1) // 2 + factor - 1
        pad1 = p // 2 + 1
        out = blur(out, _blur_taps(tuple(blur_kernel), factor ** 2), (pad0, pad1))
    elif downsample:
        factor = 2
        p = (len(blur_kernel) - factor) + (kh - 1)
        xm = blur(xm, _blur_taps(tuple(blur_kernel), 1), ((p + 1) // 2, p // 2))
        out = F.conv2d(xm, w, stride=factor)
    else:
        out = F.conv2d(xm, w, padding=kh // 2)

    if demod is not None:
        out = out * demod[:, :, None, None].to(x.dtype)
    return out
