"""DECA face alignment: FAN landmarks → kpt68 bbox → similarity warp to 224.

Counterpart of the JAX package's ``pipeline/alignment.py`` (the reference's
``libs/DECA/decalib/datasets/datasets.py:44-86``), batched: the bbox from
the landmarks, (center, size) by the kpt68 rule, and the axis-aligned warp
of the 1.25·size square to 224. Frames where no face passes the detector's
gate warp whole, and the ``ok`` mask tells the caller.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.face.fan import FAN, fan_forward, heatmaps_to_landmarks, landmarks_to_image_coords
from ..models.face.landmarks import estimate_landmarks
from ..models.face.s3fd import S3FD
from ..models.nn import resize_bilinear, scale_translate_warp

DECA_CROP = 224
DECA_SCALE = 1.25  # `datasets.py:33`


def kpt68_center_size(landmarks: torch.Tensor):
    """bbox2point(type='kpt68') (``datasets.py:47-49``): old_size =
    (w + h) / 2 · 1.1, center = the bbox center. landmarks (B, 68, 2)."""
    mins, maxs = landmarks.amin(dim=1), landmarks.amax(dim=1)
    left, top = mins[:, 0], mins[:, 1]
    right, bottom = maxs[:, 0], maxs[:, 1]
    old_size = (right - left + bottom - top) / 2.0 * 1.1
    center = torch.stack([right - (right - left) / 2.0,
                          bottom - (bottom - top) / 2.0], dim=-1)
    return center, old_size


def warp_to_224(images01: torch.Tensor, center: torch.Tensor,
                old_size: torch.Tensor) -> torch.Tensor:
    """Warp the (center, 1.25·old_size) square to 224 (``datasets.py:
    70-80``), the side truncated to an integer first as the reference's
    ``int(old_size * scale)``. images01 (B, H, W, 3) → (B, 224, 224, 3)."""
    size = torch.trunc(old_size * DECA_SCALE)
    s = (DECA_CROP - 1.0) / torch.clamp_min(size, 1.0)
    tx = -(center[:, 0] - size / 2.0) * s
    ty = -(center[:, 1] - size / 2.0) * s
    return scale_translate_warp(images01, s, tx, ty, (DECA_CROP, DECA_CROP))


def _warp_or_whole(images01: torch.Tensor, landmarks: torch.Tensor, ok: torch.Tensor):
    """kpt68 warp where ``ok``; the whole frame (size → H) elsewhere."""
    h = images01.shape[1]
    center, old_size = kpt68_center_size(landmarks)
    center = torch.where(ok[:, None], center, torch.full_like(center, h / 2.0))
    old_size = torch.where(ok, old_size, torch.full_like(old_size, h / DECA_SCALE))
    return warp_to_224(images01, center, old_size)


def landmark_align(images01: torch.Tensor, landmarks: torch.Tensor,
                   ok: Optional[torch.Tensor] = None):
    """DECA alignment from landmarks computed earlier (the preprocessing
    pass's, mapped into crop coordinates) instead of a second SFD + FAN
    pass. The landmarks are constants to autograd, as the JAX package's
    ``stop_gradient``. Returns (aligned (B, 224, 224, 3), ok)."""
    lms = landmarks.float().detach()
    if ok is None:
        ok = torch.ones(images01.shape[0], dtype=torch.bool, device=images01.device)
    return _warp_or_whole(images01, lms, ok), ok


def make_fan_align(fan: FAN, s3fd: Optional[S3FD] = None,
                   compute_dtype: Optional[torch.dtype] = None,
                   return_ok: bool = False):
    """Batched DECA aligner: [0, 1] square images → (B, 224, 224, 3).

    With ``s3fd`` (the default on every CLI path): SFD on the 256 frame in
    the "fa" convention → 200·scale crop → FAN → landmarks
    (``decalib/datasets/detectors.py:23-42``), then the kpt68 warp; frames
    with no face above the gate warp whole (``return_ok`` gives the mask).
    Without it ("fan_frame"): FAN on the whole 256 frame with center
    (128, 128) and scale 256/200, always ok. ``compute_dtype`` runs S3FD
    and FAN in that dtype.

    Gradients reach the images through the warp alone: the detector's and
    FAN's inputs and the landmarks are detached, where the JAX package
    stops them (detection runs under no-grad in the reference).
    """

    def align(images01: torch.Tensor):
        b, h = images01.shape[0], images01.shape[1]
        im256 = images01
        if h != 256:
            im256 = resize_bilinear(images01.permute(0, 3, 1, 2), (256, 256)).permute(0, 2, 3, 1)
        if s3fd is not None:
            lms, ok, _ = estimate_landmarks(s3fd, fan, im256.detach() * 255.0,
                                            compute_dtype=compute_dtype,
                                            detector_input="fa")
        else:
            fan_in = im256.detach()
            if compute_dtype is not None:
                fan_in = fan_in.to(compute_dtype)
            heat = fan_forward(fan, fan_in)[-1].float()
            dev = images01.device
            lms = landmarks_to_image_coords(
                heatmaps_to_landmarks(heat),
                torch.full((b, 2), 128.0, device=dev), torch.full((b,), 256.0 / 200.0,
                                                                   device=dev))
            ok = torch.ones(b, dtype=torch.bool, device=dev)
        if h != 256:
            lms = lms * (h / 256.0)
        aligned = _warp_or_whole(images01, lms.detach(), ok)
        return (aligned, ok) if return_ok else aligned

    return align
