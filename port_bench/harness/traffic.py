"""The one generator of inputs: a traffic file's parameters and a seed in,
frames or crops out, made on the device in a few large draws.

A frame, of the traffic's ``frame_hw``, is a grey ground of smooth random
luminance (``ground_cells`` rows and columns of cells, upsampled
bilinearly, values in ``ground_range``; black without it) with one
textured face patch of side ``patch`` at a seeded place inside
``margins`` (top, bottom, left, right), so that every FFHQ box of the
seeded nets stays inside the frame. The patch is ``texture_cells``²
random colours, upsampled bilinearly. The seeded detector sees colour
alone, so its face lies on the patch, while DECA sees the ground too. A
crop is an FFHQ-aligned portrait of side ``crop``: the same kind of
patch on a dark ground, centred up to ``jitter`` pixels off. Every seed gives the same sizes; only places and
textures change.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed * 8 + stream)
    return g


def _textures(n: int, cells: int, side: int, gen: torch.Generator) -> torch.Tensor:
    """(n, 3, side, side) float in [0, 255]."""
    grid = torch.rand(n, 3, cells, cells, generator=gen, device=gen.device) * 255.0
    return F.interpolate(grid, size=(side, side), mode="bilinear", align_corners=False)


def frames(tr: Dict, seed: int, n: int, device, stream: int = 0) -> torch.Tensor:
    """(n, H, W, 3) uint8 frames on ``device``."""
    h, w = tr["frame_hw"]
    p = tr["patch"]
    top0, bottom, left0, right = tr["margins"]
    gen = generator(seed, stream, device)
    tops = torch.randint(top0, h - p - bottom + 1, (n,), generator=gen, device=device)
    lefts = torch.randint(left0, w - p - right + 1, (n,), generator=gen, device=device)
    tex = _textures(n, tr["texture_cells"], p, gen).round().to(torch.uint8)
    out = torch.zeros(n, h, w, 3, dtype=torch.uint8, device=device)
    if "ground_cells" in tr:
        lo, hi = tr["ground_range"]
        grey = torch.rand(n, 1, *tr["ground_cells"], generator=gen, device=device)
        grey = F.interpolate(grey, size=(h, w), mode="bilinear", align_corners=False)
        out[:] = (lo + (hi - lo) * grey).round().to(torch.uint8).permute(0, 2, 3, 1)
    for i, (t, l) in enumerate(zip(tops.tolist(), lefts.tolist())):
        out[i, t:t + p, l:l + p] = tex[i].permute(1, 2, 0)
    return out


def crops(tr: Dict, seed: int, n: int, device, stream: int = 0) -> torch.Tensor:
    """(n, s, s, 3) float32 portraits in [-1, 1] on ``device``, each value
    a multiple of 1/127.5 below 1 as a decoded 8-bit image gives it."""
    s, p, j = tr["crop"], tr["patch"], tr["jitter"]
    gen = generator(seed, stream, device)
    offs = torch.randint(-j, j + 1, (n, 2), generator=gen, device=device)
    ground = torch.rand(n, 3, 1, 1, generator=gen, device=device) * 40.0
    tex = _textures(n, tr["texture_cells"], p, gen)
    out = ground.expand(n, 3, s, s).clone()
    c = (s - p) // 2
    for i, (dy, dx) in enumerate(offs.tolist()):
        out[i, :, c + dy:c + dy + p, c + dx:c + dx + p] = tex[i]
    return (out.round().permute(0, 2, 3, 1) / 127.5 - 1.0).contiguous()
