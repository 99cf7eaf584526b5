"""Landmark estimation: S3FD detect → 200·scale crop → FAN → image coords.

Counterpart of the JAX package's ``models/face/landmarks.py`` (the
reference's ``LandmarksEstimation``), batched: the reference face of each
image, its center and scale, the integer-cornered crop resized to 256 as
two dense contractions, FAN heatmaps → sub-pixel peaks → image coords;
:func:`estimate_landmarks_3d` adds each landmark's depth from the depth
net.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..nn import warp_from_coords
from .fan import (FAN, ResNetDepth, fan_forward, heatmaps_to_landmarks,
                  landmarks_to_image_coords, predict_depth)
from .s3fd import S3FD, detect_faces

REFERENCE_SCALE = 195.0  # `sfd/sfd_detector.py` (face-alignment convention)
CROP_RESOLUTION = 256.0


def box_to_center_scale(box: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """box (..., 4+) [x1, y1, x2, y2] → center (..., 2) with y lifted by
    0.12·height, scale (w + h) / 195 (``landmarks_estimation.py:145-150``)."""
    cx = (box[..., 2] + box[..., 0]) / 2.0
    cy = (box[..., 3] + box[..., 1]) / 2.0
    cy = cy - (box[..., 3] - box[..., 1]) * 0.12
    scale = (box[..., 2] - box[..., 0] + box[..., 3] - box[..., 1]) / REFERENCE_SCALE
    return torch.stack([cx, cy], dim=-1), scale


def crop_transform(center: torch.Tensor, scale: torch.Tensor,
                   resolution: float = CROP_RESOLUTION) -> torch.Tensor:
    """(B, 2) centers and (B,) scales → (B, 3, 3) src→dst affines of the
    200·scale crop: dst = res/h·(src − center) + res/2 with h = 200·scale
    (``fan_model/utils.py:63-97``), on the centers' device."""
    h = 200.0 * scale
    s = resolution / h
    zeros, ones = torch.zeros_like(s), torch.ones_like(s)
    tx = resolution * (-center[:, 0] / h + 0.5)
    ty = resolution * (-center[:, 1] / h + 0.5)
    return torch.stack([torch.stack([s, zeros, tx], dim=-1),
                        torch.stack([zeros, s, ty], dim=-1),
                        torch.stack([zeros, zeros, ones], dim=-1)], dim=1)


def crop_faces(images: torch.Tensor, center: torch.Tensor, scale: torch.Tensor,
               resolution: int = 256) -> torch.Tensor:
    """The reference's ``crop_torch`` (``fan_model/utils.py:141-165``),
    batched: corners from the inverse transform truncated to integers, the
    patch zero-padded outside the frame and resized to ``resolution`` with
    F.interpolate's bilinear rule (half-pixel centers, samples clamped to
    the patch). images (B, H, W, C) in any range → (B, res, res, C) f32."""
    res = float(resolution)
    h = 200.0 * scale
    ul_x = torch.trunc(center[:, 0] - h / 2.0 + h / res)
    ul_y = torch.trunc(center[:, 1] - h / 2.0 + h / res)
    br_x = torch.trunc(center[:, 0] + h / 2.0)
    br_y = torch.trunc(center[:, 1] + h / 2.0)
    wp, hp = br_x - ul_x, br_y - ul_y                      # patch size (B,)
    dst = torch.arange(resolution, dtype=torch.float32, device=images.device) + 0.5
    sx = torch.clamp(dst[None] * (wp[:, None] / res) - 0.5,
                     torch.zeros_like(wp[:, None]), wp[:, None] - 1.0) + ul_x[:, None]
    sy = torch.clamp(dst[None] * (hp[:, None] / res) - 0.5,
                     torch.zeros_like(hp[:, None]), hp[:, None] - 1.0) + ul_y[:, None]
    return warp_from_coords(images, sy, sx)


def select_reference_face(boxes: torch.Tensor, valid: torch.Tensor,
                          conf_thresh: float = 0.99
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The face the reference keeps: it walks the NMS list best first and
    overwrites its landmarks for every face above the gate
    (``landmarks_estimation.py:203-208``), so the LAST passing face wins.
    boxes (B, K, 5), valid (B, K) → (box (B, 5), ok (B,)); box 0 where
    none passes."""
    passing = valid & (boxes[..., 4] > conf_thresh)          # (B, K)
    k = boxes.shape[1]
    idx = (k - 1) - torch.argmax(passing.flip(1).to(torch.uint8), dim=1)
    ok = passing.any(dim=1)
    idx = torch.where(ok, idx, torch.zeros_like(idx))
    box = torch.gather(boxes, 1, idx[:, None, None].expand(-1, 1, boxes.shape[2]))[:, 0]
    return box, ok


def estimate_landmarks(s3fd: S3FD, fan: FAN, images_rgb255: torch.Tensor,
                       conf_thresh: float = 0.99,
                       compute_dtype: Optional[torch.dtype] = None,
                       detector_input: str = "vendored"
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) RGB 0-255 → landmarks (B, 68, 2) in image coords, ok
    (B,), heatmaps (B, 64, 64, 68) float32.

    ``detector_input``: "vendored" feeds the raw RGB to SFD (the
    preprocessing path, ``sfd/detect.py:36-45``); "fa" flips to BGR and
    subtracts the mean (the face_alignment detector that DECA wraps). FAN
    reads the [0, 1] crop in both. ``compute_dtype`` runs S3FD and FAN in
    that dtype; boxes, heatmap peaks and coordinates stay float32.
    Detection is detached (the boxes are constants to autograd, as the
    JAX package's ``stop_gradient``); FAN's crops are not.
    """
    if detector_input == "fa":
        det_in, sub_mean = images_rgb255.flip(-1), True
    elif detector_input == "vendored":
        det_in, sub_mean = images_rgb255, False
    else:
        raise ValueError(f"unknown detector_input {detector_input!r}")
    det_in = det_in.detach()
    if compute_dtype is not None:
        det_in = det_in.to(compute_dtype)
    boxes, valid = detect_faces(s3fd, det_in, subtract_mean=sub_mean)
    best, ok = select_reference_face(boxes.float(), valid, conf_thresh)
    best = best.detach()

    center, scale = box_to_center_scale(best)
    crops = crop_faces(images_rgb255, center, scale, 256) / 255.0
    if compute_dtype is not None:
        crops = crops.to(compute_dtype)
    heatmaps = fan_forward(fan, crops)[-1].float()
    pts_img = landmarks_to_image_coords(heatmaps_to_landmarks(heatmaps), center, scale)
    return pts_img, ok, heatmaps


def estimate_landmarks_3d(s3fd: S3FD, fan: FAN, depth: ResNetDepth,
                          images_rgb255: torch.Tensor, conf_thresh: float = 0.99
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3D variant (``landmarks_estimation.py`` type '3D'): the 2D
    landmarks of the best NMS box and their depths from the depth net fed
    with the crop and a gaussian heatmap a landmark (``:165-181``). images
    (B, H, W, 3) RGB 0-255, the vendored detector input (raw RGB, no mean).
    Returns ((B, 68, 3), ok (B,)). The detector's input and the box are
    constants to autograd, as the JAX package's two ``stop_gradient``s;
    the crops, FAN and the depth net are not."""
    boxes, valid = detect_faces(s3fd, images_rgb255.detach(), subtract_mean=False)
    best = boxes[:, 0].float().detach()
    ok = valid[:, 0] & (best[:, 4] > conf_thresh)
    center, scale = box_to_center_scale(best)
    crops = crop_faces(images_rgb255, center, scale, 256) / 255.0
    heatmaps = fan_forward(fan, crops)[-1]
    pts_hm = heatmaps_to_landmarks(heatmaps)
    pts_img = landmarks_to_image_coords(pts_hm, center, scale)
    z = predict_depth(depth, crops, pts_hm, scale)
    return torch.cat([pts_img, z[..., None]], dim=-1), ok
