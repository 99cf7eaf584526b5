"""Host image operations and video files.

* :func:`resize_bilinear_u8`, :func:`to_gan_range` and
  :func:`from_gan_range` are PyTorch or numpy on the CPU, with the
  arithmetic of the JAX package's native library (``reenact_io.cpp``): the
  resize takes half-pixel centres, clamps at the low edge and interpolates
  in float64; it and ``from_gan_range`` round half up.
* :func:`ffhq_crop_batch` is the FFHQ crop of in-frame boxes with the
  contract of ``rio_ffhq_crop_batch``, one frame after another, each crop
  made by ``models/face/cropping.py::resample_u8``. The JAX package's
  native library spreads the frames over threads; on the H100's host eight
  workers were slower than one loop running torch on every core.
* :func:`extract_frames`, :func:`video_fps` and :func:`generate_video` read
  and write video with OpenCV's ``VideoCapture`` and ``VideoWriter`` (fourcc
  ``mp4v``), as the reference does (``utils_inference.py:11-58``). cv2 is
  imported inside them, and frames are RGB on both sides of the calls.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

def _capture(path: str):
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"could not open video {path}")
    return cap


def extract_frames(path: str, stride: int = 1, max_frames: int = 100_000,
                   get_only_first: bool = False) -> List[np.ndarray]:
    """mp4/avi → HWC uint8 RGB frames, every ``stride``-th
    (``utils_inference.py:35-58``: the reference's ``fps`` argument is a
    stride); ``get_only_first`` returns frame 0 alone."""
    import cv2
    limit = 1 if get_only_first else max_frames
    stride = 1 if get_only_first else max(stride, 1)
    cap = _capture(path)
    try:
        frames: List[np.ndarray] = []
        index = 0
        while len(frames) < limit:
            ok, bgr = cap.read()
            if not ok:
                break
            if index % stride == 0:
                frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
            index += 1
        return frames
    finally:
        cap.release()


def video_fps(path: str) -> float:
    """The video's frame rate."""
    import cv2
    cap = _capture(path)
    try:
        return float(cap.get(cv2.CAP_PROP_FPS))
    finally:
        cap.release()


def generate_video(frames: List[np.ndarray], save_path: str, fps: int = 25) -> None:
    """RGB uint8 frames → mp4 (``utils_inference.py:11-18``), fourcc
    ``mp4v``. The last frame is written twice, as the JAX package's libav
    writer does: some decoders swallow an mp4's final sample at the end of
    the stream, so every real frame decodes everywhere and a player holds
    the last image one frame longer."""
    import cv2
    if not frames:
        return
    h, w = frames[0].shape[:2]
    checked = []
    for f in list(frames) + [frames[-1]]:
        f = np.ascontiguousarray(f, np.uint8)
        if f.shape != (h, w, 3):
            raise ValueError(f"frame of shape {f.shape}, expected {(h, w, 3)}")
        checked.append(f)
    writer = cv2.VideoWriter(save_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise IOError(f"could not open a video writer for {save_path}")
    try:
        for f in checked:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


def _axis(n_in: int, n_out: int):
    """(low index, high index, weight of the high one) per output
    coordinate, float64: half-pixel centres, clamped at the low edge."""
    f = (torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out) - 0.5
    f = f.clamp_min(0.0)
    lo = f.floor()
    hi = torch.clamp(lo + 1, max=n_in - 1)
    return lo.long(), hi.long(), f - lo


def resize_bilinear_u8(batch, out_hw: Tuple[int, int]) -> np.ndarray:
    """(N, H, W, 3) uint8 → (N, oh, ow, 3) uint8, bilinear."""
    x = torch.as_tensor(np.ascontiguousarray(batch, np.uint8)).to(torch.float64)
    y0, y1, wy = _axis(x.shape[1], out_hw[0])
    x0, x1, wx = _axis(x.shape[2], out_hw[1])
    wy, wx = wy[:, None, None], wx[:, None]
    top, bot = x[:, y0], x[:, y1]
    v = (1 - wy) * ((1 - wx) * top[:, :, x0] + wx * top[:, :, x1]) \
        + wy * ((1 - wx) * bot[:, :, x0] + wx * bot[:, :, x1])
    return torch.floor(v + 0.5).to(torch.uint8).numpy()


def to_gan_range(image_uint8: np.ndarray) -> np.ndarray:
    """uint8 → float32 in [-1, 1] (ToTensor → Normalize(.5, .5, .5),
    ``dataloader.py:31-34``)."""
    return np.asarray(image_uint8).astype(np.float32) / 127.5 - 1.0


def from_gan_range(batch_f32) -> np.ndarray:
    """float32 in [-1, 1] (an array or a CPU tensor) → uint8, clipped and
    rounded half up."""
    x = torch.as_tensor(batch_f32, dtype=torch.float32)
    return torch.floor(((x + 1.0) * 127.5).clamp(0.0, 255.0) + 0.5).to(torch.uint8).numpy()


def ffhq_crop_batch(images: np.ndarray, landmarks: np.ndarray,
                    image_size: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """(B, H, W, 3) uint8 frames of one shape and (B, 68, 2) landmarks →
    (crops (B, s, s, 3) uint8, done (B,) bool): the FFHQ crop of every box
    inside its frame. ``done[i]`` is False where the box leaves the frame
    or the landmarks are degenerate; that crop stays zero and is the
    caller's (``models/face/cropping.py::crop_using_landmarks``)."""
    from ..models.face.cropping import ffhq_box, resample_u8
    images = np.ascontiguousarray(images, np.uint8)
    landmarks = np.asarray(landmarks, np.float32)
    b, h, w, _ = images.shape
    crops = np.zeros((b, image_size, image_size, 3), np.uint8)
    done = np.zeros((b,), bool)
    for i in range(b):
        box = ffhq_box(landmarks[i])
        if box is None:
            continue
        x1, y1, x2, y2 = box
        if x1 >= 0 and y1 >= 0 and x2 <= w and y2 <= h:
            crops[i] = resample_u8(images[i, y1:y2, x1:x2], (image_size, image_size))
            done[i] = True
    return crops, done
