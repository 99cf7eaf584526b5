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
