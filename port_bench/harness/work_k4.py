"""K4's work, counted from a call's shapes and arguments: the filtered
leaky ReLU's FIR FMAs in the polyphase form (an upsampled sample takes only
the taps of its phase, so no zero-stuffed tap is counted; each filter as
two 1-D passes, x then y), and its bytes (the input read once, the output
written once, the bias). K4 runs its products on the CUDA cores in float32,
so its share of a roofline is against the float32 peak of the CUDA cores
(67 TFLOP/s, not the TF32 tensor-core rate) and the memory's 3.35 TB/s."""

from __future__ import annotations

from typing import Optional, Sequence

from .common import PEAK_BYTES

PEAK_FP32_FLOPS = 67e12      # H100 SXM, CUDA cores, dense (data sheet; 700 W)


def k4_out_hw(h: int, w: int, ku: int, kd: int, up: int, down: int, pad: Sequence[int]):
    px0, px1, py0, py1 = pad
    return ((h * up + py0 + py1 - (ku - 1) - (kd - 1) + down - 1) // down,
            (w * up + px0 + px1 - (ku - 1) - (kd - 1) + down - 1) // down)


def k4_flops(shape: Sequence[int], ku: int, kd: int, up: int, down: int,
             pad: Sequence[int]) -> float:
    """2 × the FMAs of one call on an NCHW input of ``shape``: the x pass of
    the upsampling over the input's rows, its y pass over the upsampled
    plane, each at ku / up taps a sample; the x pass of the downsampling
    over the upsampled rows and the kept columns, its y pass over the
    output, each at kd taps."""
    n, c, h, w = shape
    px0, px1, py0, py1 = pad
    h1 = h * up + py0 + py1 - ku + 1
    w1 = w * up + px0 + px1 - ku + 1
    oh, ow = k4_out_hw(h, w, ku, kd, up, down, pad)
    per_plane = (h * w1 + h1 * w1) * ku / up + (h1 * ow + oh * ow) * kd
    return 2.0 * n * c * per_plane


def k4_bytes(shape: Sequence[int], ku: int, kd: int, up: int, down: int, pad: Sequence[int],
             itemsize: int = 4) -> float:
    n, c, h, w = shape
    oh, ow = k4_out_hw(h, w, ku, kd, up, down, pad)
    return float(n * c * (h * w + oh * ow) * itemsize + 4 * c)


def k4_roofline_pct(flops: float, nbytes: float, seconds: float) -> Optional[float]:
    if seconds <= 0:
        return None
    return 100.0 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) / seconds
