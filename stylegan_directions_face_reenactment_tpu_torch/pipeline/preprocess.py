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

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.face.cropping import (crop_using_landmarks_batch, ffhq_crop_device,
                                    landmarks_in_crop)
from ..models.face.fan import FAN
from ..models.face.landmarks import estimate_landmarks
from ..models.face.s3fd import S3FD
from ..native.imgproc import to_gan_range
from ..utils.device import DeviceLike, resolve_device

DETECT_WIDTH = 1000  # `utils_inference.py:67` image_resize(width=1000)


def resize_width(image: np.ndarray, width: int = DETECT_WIDTH) -> np.ndarray:
    """Rescale so that the width is ``width``, up or down, keeping the
    aspect (the reference's ``image_resize(width=1000)``,
    ``image_utils.py:36-66``, cv2.INTER_AREA). cv2 where it is importable;
    else Pillow (BOX down, BILINEAR up), which approximates it."""
    h, w = image.shape[:2]
    if w == width:
        return image
    dim = (width, int(h * (width / float(w))))
    try:
        import cv2
    except ImportError:
        from PIL import Image
        resample = Image.BOX if width < w else Image.BILINEAR
        return np.array(Image.fromarray(image).resize(dim, resample))
    return cv2.resize(image, dim, interpolation=cv2.INTER_AREA)


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


def preprocess_images(s3fd_params: S3FD, fan_params: FAN, images: List[np.ndarray],
                      image_size: int = 256, device_crop: bool = False,
                      return_landmarks: bool = False,
                      detect_width: Optional[int] = DETECT_WIDTH,
                      device: DeviceLike = None) -> Tuple[np.ndarray, ...]:
    """HWC uint8 RGB frames → ((B, s, s, 3) float32 crops in [-1, 1], ok
    (B,)), and with ``return_landmarks`` the landmarks in crop coordinates
    (B, 68, 2).

    ``detect_width`` rescales every frame to that width first (None or 0:
    detect at the frame's own size). Frames are batched by shape, one
    device call a shape, on ``device`` (the CUDA card by default; it raises
    when there is none). ``device_crop`` cuts the in-frame crops on the
    device; the host crop takes the rest, and all of them without it.
    """
    dev = resolve_device(device)
    for m in (s3fd_params, fan_params):
        m.to(dev).eval()
    resized = ([resize_width(im, detect_width) for im in images] if detect_width
               else [np.asarray(im) for im in images])

    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i, im in enumerate(resized):
        buckets.setdefault(im.shape[:2], []).append(i)

    out = np.zeros((len(resized), image_size, image_size, 3), np.float32)
    lms = np.zeros((len(resized), 68, 2), np.float32)
    ok = np.zeros(len(resized), bool)
    host_crop = np.ones(len(resized), bool)
    with torch.inference_mode():
        for idxs in buckets.values():
            batch = torch.as_tensor(np.stack([resized[i] for i in idxs]).astype(np.uint8),
                                    device=dev)
            if device_crop:
                crops, valid, in_frame, pts = (t.cpu().numpy() for t in preprocess_batch_device(
                    s3fd_params, fan_params, batch, image_size=image_size))
                keep = valid & in_frame
                out[np.array(idxs)[keep]] = crops[keep]
                host_crop[np.array(idxs)[keep]] = False
            else:
                pts, valid, _ = (t.cpu().numpy() for t in estimate_landmarks(
                    s3fd_params, fan_params, batch.float()))
            lms[idxs], ok[idxs] = pts, valid

    det = np.nonzero(ok & host_crop)[0]
    if det.size:
        crops, crop_ok = crop_using_landmarks_batch([resized[i] for i in det], lms[det],
                                                    image_size=image_size)
        out[det[crop_ok]] = to_gan_range(crops[crop_ok])
        ok[det[~crop_ok]] = False
    if not return_landmarks:
        return out, ok
    lms_crop, _ = landmarks_in_crop(torch.from_numpy(lms), image_size=image_size)
    return out, ok, lms_crop.numpy()
