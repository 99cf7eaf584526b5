"""The shapes at which one serving request, or one PTI step of source
set-up, calls each kernel.

For a batch of ``batch`` frames through a generator of ``size`` and
``channel_multiplier``: K1 runs the blur after each upsampling StyledConv
((B, C_R, R+1, R+1) → (B, C_R, R, R), 4×4 taps of gain 4, pad (1, 1)) and
each ToRGB skip upsample ((B, 3, H, H) → (B, 3, 2H, 2H), pad (2, 1)); K2
runs on each StyledConv's output (conv1 at 4², then two a resolution).
A PTI step (:func:`pti_backward_calls`) runs the forward calls at batch 1
and, in its backward, the kernels on what lies downstream of the tuned
``convs[4..11]``. ``chip_smoke.py`` and the card-only tests hold the
kernels at these shapes.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

from ..models.stylegan2 import channel_map
from ..pipeline.pti import TUNED_CONV_RANGE


class K1Call(NamedTuple):
    name: str
    shape: Tuple[int, int, int, int]   # NCHW input
    up: int
    pad: Tuple[int, int]


def upfirdn2d_calls(size: int = 256, channel_multiplier: int = 1,
                    batch: int = 16) -> List[K1Call]:
    channels = channel_map(channel_multiplier)
    calls = []
    for i in range(3, int(math.log2(size)) + 1):
        r = 2 ** i
        calls.append(K1Call(f"blur{r}", (batch, channels[r], r + 1, r + 1), 1, (1, 1)))
        calls.append(K1Call(f"skip{r // 2}", (batch, 3, r // 2, r // 2), 2, (2, 1)))
    return calls


def fused_bias_act_calls(size: int = 256, channel_multiplier: int = 1,
                         batch: int = 16) -> List[Tuple[int, ...]]:
    channels = channel_map(channel_multiplier)
    calls = [(batch, channels[4], 4, 4)]
    for i in range(3, int(math.log2(size)) + 1):
        r = 2 ** i
        calls += [(batch, channels[r], r, r)] * 2
    return calls


class PTIBackward(NamedTuple):
    """The backward launches of one PTI step: K1 on the gradient of each
    forward call in ``upfirdn2d`` (the blurs of the tuned upsampling convs:
    up 1, down 1; the skip upsamples of ToRGB outputs that depend on a tuned
    conv: up 1, down 2), K2-bwd at each ``fused_bias_act`` shape (the tuned
    StyledConvs' outputs)."""
    upfirdn2d: List[K1Call]
    fused_bias_act: List[Tuple[int, ...]]


def pti_backward_calls(size: int = 256, channel_multiplier: int = 1,
                       batch: int = 1) -> PTIBackward:
    """convs[i] runs at 2^(3 + i // 2); the even ones upsample and blur.
    ToRGB j upsamples the RGB of ToRGB j − 1 (at 2^(2 + j)), which depends
    on a tuned conv once that resolution reaches the first tuned conv's.
    At 256² (channel multiplier 1, batch 1): 4 blurs, 3 skips (into 64²,
    128² and 256²), 8 activations."""
    channels = channel_map(channel_multiplier)
    lo, hi = TUNED_CONV_RANGE
    first = 2 ** (3 + lo // 2)
    k1, k2 = [], []
    for i in range(lo, min(hi, 2 * (int(math.log2(size)) - 2))):
        r = 2 ** (3 + i // 2)
        if i % 2 == 0:
            k1.append(K1Call(f"blur{r}", (batch, channels[r], r + 1, r + 1), 1, (1, 1)))
        k2.append((batch, channels[r], r, r))
    r = first
    while r < size:
        k1.append(K1Call(f"skip{r}", (batch, 3, r, r), 2, (2, 1)))
        r *= 2
    return PTIBackward(k1, k2)


FAN_MODULES = 4
# the channels-equal 256-channel blocks of one FAN module: hourglass level 4
# b1 and top_m at 64², then b1/b2/b3 of levels 3..1 with b2_plus at 4² —
# three blocks at each of 32², 16², 8² and 4² (b2 of level 4 runs at 32²)
_K3_SIZES = (64, 64, 32, 32, 32, 16, 16, 16, 8, 8, 8, 4, 4, 4)


def fused_conv_block_calls(batch: int = 16,
                           num_modules: int = FAN_MODULES) -> List[Tuple[int, ...]]:
    """The K3 input shapes (NCHW) of one FAN pass over ``batch`` crops: 14
    blocks a module. The default per-frame path runs two passes a request
    (preprocessing and the DECA alignment)."""
    return [(batch, 256, s, s) for s in _K3_SIZES] * num_modules
