"""FFHQ-style landmark crop, the device half.

Counterpart of the JAX package's ``models/face/cropping.py`` (the
reference's ``libs/face_models/ffhq_cropping.py``) for in-frame boxes:
the landmark box (center with y lifted by size/6, square of side 2·size)
and a PIL-compatible antialiased bicubic resample to 256, as two dense f32
contractions with the uint8 quantization between the passes that the host
pipelines apply. The host crop (reflect-pad, blur and median fade for boxes
that leave the frame) is not ported yet; such frames come back with
``in_frame`` False.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..nn import full_f32_matmul


def ffhq_crop_box(landmarks: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """landmarks (B, 68, 2) → center (B, 2) int32 [x, y] with the y − size/6
    lift, size (B,) int32, valid (B,) (``ffhq_cropping.py:49-57``)."""
    lm = landmarks.float()
    mins, maxs = lm.amin(dim=1), lm.amax(dim=1)
    center = torch.round((mins + maxs) / 2.0).to(torch.int32)   # half to even, as np.round
    ext = maxs - mins
    size = torch.maximum(ext[:, 0], ext[:, 1]).to(torch.int32)   # int() truncation
    valid = size > 0
    center = torch.stack([center[:, 0], center[:, 1] - torch.div(size, 6, rounding_mode="floor")],
                         dim=-1)
    return center, size, valid


def landmarks_in_crop(landmarks: torch.Tensor, image_size: int = 256
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw-frame landmarks → FFHQ-crop coordinates: (lm − origin) ·
    image_size / side for the crop square (origin center − size, side
    2·size). Returns (lms (B, 68, 2), valid (B,))."""
    center, size, valid = ffhq_crop_box(landmarks)
    origin = (center - size[:, None]).float()
    side = (2 * torch.clamp_min(size, 1)).float()
    lms = (landmarks.float() - origin[:, None, :]) * (image_size / side)[:, None, None]
    return lms, valid


def cubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic with a = −0.5 (PIL BICUBIC)."""
    x = x.abs()
    near = ((-0.5 + 2.0) * x - (-0.5 + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far, torch.zeros_like(x)))


def pil_axis_weights(in_len: int, start: torch.Tensor, crop_len: torch.Tensor,
                     out_len: int) -> torch.Tensor:
    """Per-image resampling weights of PIL's antialiased cubic for one axis:
    window [lo, hi) from the ±support rule, normalized over the window.
    start / crop_len (B,): the crop's origin and side in image coords.
    Returns (B, out_len, in_len)."""
    dev = start.device
    scale = crop_len / out_len                                   # (B,)
    filterscale = torch.clamp_min(scale, 1.0)
    support = 2.0 * filterscale
    i = torch.arange(out_len, dtype=torch.float32, device=dev)
    center = (i[None] + 0.5) * scale[:, None]                    # (B, O) crop coords
    lo = torch.clamp_min(torch.floor(center - support[:, None] + 0.5), 0.0)
    hi = torch.minimum(torch.floor(center + support[:, None] + 0.5), crop_len[:, None])
    j = torch.arange(in_len, dtype=torch.float32, device=dev)
    jc = j[None, None, :] - start[:, None, None]                 # (B, 1, In)
    w = cubic_kernel((jc - center[..., None] + 0.5) / filterscale[:, None, None])
    w = torch.where((jc >= lo[..., None]) & (jc < hi[..., None]), w, torch.zeros_like(w))
    norm = w.sum(dim=-1, keepdim=True)
    return w / torch.where(norm == 0.0, torch.ones_like(norm), norm)


def _q8(v: torch.Tensor) -> torch.Tensor:
    """clip to [0, 255] and round half up: the u8 quantization between the
    passes."""
    return torch.floor(torch.clamp(v, 0.0, 255.0) + 0.5)


def ffhq_crop_device(images: torch.Tensor, landmarks: torch.Tensor,
                     image_size: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B, H, W, 3) uint8 or float, landmarks (B, 68, 2) → (crops
    (B, s, s, 3) float32 in [0, 255], integer-valued; in_frame (B,)).
    ``in_frame`` is False where the box leaves the frame or the landmarks
    are degenerate: those crops are edge-clamped approximations."""
    _, h, w, _ = images.shape
    center, size, valid = ffhq_crop_box(landmarks)
    cx, cy = center[:, 0], center[:, 1]
    x1, y1 = cx - size, cy - size
    in_frame = (x1 >= 0) & (y1 >= 0) & (cx + size <= w) & (cy + size <= h) & valid
    side = (2 * torch.clamp_min(size, 1)).float()
    wx = pil_axis_weights(w, x1.float(), side, image_size)
    wy = pil_axis_weights(h, y1.float(), side, image_size)
    with full_f32_matmul():
        tmp = _q8(torch.einsum("box,byxc->byoc", wx, images.float()))
        out = _q8(torch.einsum("boy,byic->boic", wy, tmp))
    return out, in_frame
