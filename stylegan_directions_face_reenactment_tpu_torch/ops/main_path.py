"""The shapes at which one serving request calls each kernel.

For a batch of ``batch`` frames through a generator of ``size`` and
``channel_multiplier``: K1 runs the blur after each upsampling StyledConv
((B, C_R, R+1, R+1) → (B, C_R, R, R), 4×4 taps of gain 4, pad (1, 1)) and
each ToRGB skip upsample ((B, 3, H, H) → (B, 3, 2H, 2H), pad (2, 1)); K2
runs on each StyledConv's output (conv1 at 4², then two a resolution).
``chip_smoke.py`` and the card-only tests hold the kernels at these shapes.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

from ..models.stylegan2 import channel_map


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
