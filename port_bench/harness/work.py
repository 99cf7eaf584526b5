"""The work a call needs, counted from its shapes by the benchmark's own
formulas, and the model's FLOPs counted over the plain reference.

A kernel's share of its roofline is the least time the card could take,
the larger of its operations over the TF32 dense peak and its bytes over
the memory's peak, divided by the device time measured for it."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from .common import PEAK_BYTES, PEAK_TF32_FLOPS

# K3, FAN's channels-equal ConvBlock: three 3x3 convolutions 256→128→64→64
K3_STAGES = ((256, 128), (128, 64), (64, 64))
K3_FLOP_PER_PIXEL = sum(2 * 9 * cin * cout for cin, cout in K3_STAGES)   # 811,008


def k3_flops(shape: Sequence[int]) -> float:
    b, _, h, w = shape
    return float(b * h * w * K3_FLOP_PER_PIXEL)


def k3_bytes(shape: Sequence[int], itemsize: int = 4) -> float:
    """x read once, the block's output (same shape) written once, the
    three weights read once."""
    b, c, h, w = shape
    weights = sum(9 * cin * cout for cin, cout in K3_STAGES)
    return float((2 * b * c * h * w + weights) * itemsize)


def upfirdn2d_out_hw(h: int, w: int, taps_shape: Sequence[int], up: int,
                     pad: Sequence[int]):
    """The output size of upfirdn2d at down 1; ``pad`` (p0, p1) on both axes
    or (px0, px1, py0, py1)."""
    kh, kw = taps_shape
    px0, px1, py0, py1 = (pad[0], pad[1], pad[0], pad[1]) if len(pad) == 2 else pad
    return h * up + py0 + py1 - kh + 1, w * up + px0 + px1 - kw + 1


def k1_bytes(shape: Sequence[int], taps_shape: Sequence[int], up: int,
             pad: Sequence[int], itemsize: int = 4) -> float:
    """The input read once and the output written once."""
    b, c, h, w = shape
    oh, ow = upfirdn2d_out_hw(h, w, taps_shape, up, pad)
    return float((b * c * h * w + b * c * oh * ow) * itemsize)


def roofline_pct(flops: float, nbytes: float, seconds: float) -> Optional[float]:
    if seconds <= 0:
        return None
    return 100.0 * max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES) / seconds


def mfu_pct(flops: float, seconds: float) -> Optional[float]:
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / PEAK_TF32_FLOPS


def count_flops(fn: Callable[[], object]) -> float:
    """Matrix and convolution FLOPs of ``fn``, forward and any backward it
    runs, by ``torch.utils.flop_counter``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())
