"""Preprocessing: detect → landmarks → FFHQ crop → [-1, 1].

Counterpart of the JAX package's ``pipeline/preprocess.py`` (the
reference's ``utils_inference.py:61-82``): every frame is rescaled to width
1000 on the host (:func:`resize_width`), SFD and FAN find its landmarks on
the device, and the FFHQ crop is cut on the device
(:func:`preprocess_batch_device`) or on the host
(``models/face/cropping.py::crop_using_landmarks_batch``), which also takes
every box that leaves the frame.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.face.cropping import ffhq_crop_device
from ..models.face.fan import FAN
from ..models.face.landmarks import estimate_landmarks
from ..models.face.s3fd import S3FD


def preprocess_batch_device(s3fd: S3FD, fan: FAN, frames: torch.Tensor,
                            image_size: int = 256,
                            compute_dtype: Optional[torch.dtype] = None):
    """frames (B, H, W, 3) uint8 or float RGB on the device → (crops
    (B, s, s, 3) float32 in [-1, 1], ok (B,) detection mask, in_frame (B,),
    landmarks (B, 68, 2) in frame coordinates)."""
    imgs = frames.float()
    pts, ok, _ = estimate_landmarks(s3fd, fan, imgs, compute_dtype=compute_dtype)
    crops, in_frame = ffhq_crop_device(imgs, pts, image_size=image_size)
    return crops / 127.5 - 1.0, ok, in_frame, pts
