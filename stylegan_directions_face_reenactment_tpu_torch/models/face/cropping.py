"""FFHQ-style landmark crop.

Counterpart of the JAX package's ``models/face/cropping.py`` (the
reference's ``libs/face_models/ffhq_cropping.py``): the landmark box
(center with y lifted by size/6, square of side 2·size) and a
PIL-compatible antialiased bicubic resample to 256, as two dense f32
contractions with the uint8 quantization between the passes that PIL
applies.

* :func:`ffhq_crop_device` crops a batch on the device; boxes that leave
  the frame come back with ``in_frame`` False.
* :func:`crop_using_landmarks` and :func:`crop_using_landmarks_batch` are
  the host crop, for every box: where the box leaves the frame, the frame
  is reflect-padded and its padding blurred and faded to the median
  (numpy, scipy), then cropped and resampled with the same weights on the
  CPU. The JAX package resamples there with Pillow or its native library.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage
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


# ---------------------------------------------------------------------------
# The host crop
# ---------------------------------------------------------------------------

def _pad_and_fade(img: np.ndarray, x1: int, x2: int, y1: int, y2: int,
                  crop_box) -> tuple:
    """Reflect-pad the frame to hold the crop box, then blur and fade the
    padding toward the median (``ffhq_cropping.py:13-37``). numpy's
    ``symmetric`` is cv2's BORDER_REFLECT, the reference's mode."""
    h0, w0 = img.shape[:2]
    top, bottom = -min(0, y1), max(y2 - h0, 0)
    left, right = -min(0, x1), max(x2 - w0, 0)
    img_p = np.pad(img, ((top, bottom), (left, right), (0, 0)), mode="symmetric")
    y1, y2, x1, x2 = y1 + top, y2 + top, x1 + left, x2 + left

    pad = np.array([max(-crop_box[0], 0), max(-crop_box[1], 0),
                    max(crop_box[2] - w0, 0), max(crop_box[3] - h0, 0)], dtype=np.float32)
    pad[pad == 0] = 1e-10
    h, w = img_p.shape[:2]
    y, x, _ = np.ogrid[:h, :w, :1]
    mask = np.maximum(
        1.0 - np.minimum(np.float32(x) / pad[0], np.float32(w - 1 - x) / pad[2]),
        1.0 - np.minimum(np.float32(y) / pad[1], np.float32(h - 1 - y) / pad[3]))

    out = img_p.astype(np.float32)
    blur = 5.0
    out += (scipy.ndimage.gaussian_filter(out, [blur, blur, 0]) - out) * \
        np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
    out += (np.median(out, axis=(0, 1)) - out) * np.clip(mask, 0.0, 1.0)
    return out, x1, x2, y1, y2


def crop_from_bbox(img: np.ndarray, bbox) -> np.ndarray:
    """The (x1, y1, x2, y2) box of ``img``, padded and faded where it leaves
    the frame (``ffhq_cropping.py:39-47``)."""
    x1, y1, x2, y2 = bbox
    if x1 < 0 or y1 < 0 or x2 > img.shape[1] or y2 > img.shape[0]:
        img, x1, x2, y1, y2 = _pad_and_fade(img, x1, x2, y1, y2, bbox)
    return img[y1:y2, x1:x2]


def resample_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(h, w, C) uint8 → (out_h, out_w, C) uint8 as Pillow's bicubic
    ``resize``: the weights of :func:`pil_axis_weights`, the rows first,
    each pass quantized to uint8, on the CPU."""
    h, w = img.shape[:2]
    zero = torch.zeros(1)
    wx = pil_axis_weights(w, zero, torch.tensor([float(w)]), out_hw[1])[0]
    wy = pil_axis_weights(h, zero, torch.tensor([float(h)]), out_hw[0])[0]
    x = torch.from_numpy(np.ascontiguousarray(img)).float()
    with full_f32_matmul():
        tmp = _q8(torch.einsum("ox,yxc->yoc", wx, x))
        out = _q8(torch.einsum("oy,yic->oic", wy, tmp))
    return out.to(torch.uint8).numpy()


def crop_using_landmarks(image: np.ndarray, landmarks,
                         image_size: int = 256) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 frame and (68, 2) landmarks → (image_size,
    image_size, 3) uint8 crop, or None for degenerate landmarks
    (``ffhq_cropping.py:49-69``); the box math in float64 as the
    reference's."""
    landmarks = np.asarray(landmarks, dtype=np.float64)
    center = ((landmarks.min(0) + landmarks.max(0)) / 2).round().astype(int)
    size = int(max(landmarks[:, 0].max() - landmarks[:, 0].min(),
                   landmarks[:, 1].max() - landmarks[:, 1].min()))
    if size <= 0:
        return None
    center[1] -= size // 6
    box = (int(center[0] - size), int(center[1] - size),
           int(center[0] + size), int(center[1] + size))
    cropped = crop_from_bbox(np.asarray(image), box)
    if cropped.size == 0:
        return None
    return resample_u8(np.clip(cropped, 0, 255).astype(np.uint8), (image_size, image_size))


def crop_using_landmarks_batch(images: Sequence[np.ndarray], landmarks_list,
                               image_size: int = 256
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Frames (any shapes) and their (68, 2) landmarks → (crops (B, s, s, 3)
    uint8, ok (B,)); ``ok`` is False for degenerate landmarks."""
    b = len(images)
    out = np.zeros((b, image_size, image_size, 3), np.uint8)
    ok = np.zeros((b,), bool)
    for i in range(b):
        crop = crop_using_landmarks(images[i], landmarks_list[i], image_size)
        if crop is not None:
            out[i], ok[i] = crop, True
    return out, ok
