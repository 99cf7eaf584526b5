"""Landmark drawings, interpolation charts and GIFs (the reference's
``libs/utilities/visualization.py`` and ``decalib/utils/util.py``; the JAX
package's ``utils/visualization.py``).

Drawings are numpy on the host, without cv2; Pillow is imported by
:func:`save_gif` alone. :func:`make_interpolation_chart` synthesizes every
frame of the chart in one batch.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.direction_matrix import DirectionMatrix, direction_matrix_forward
from ..models.stylegan2 import Generator
from ..pipeline.synthesis import generate_image
from .image_utils import tensor_to_image

# where the 68-landmark contour breaks (jaw / brows / nose / eyes / lips),
# ``decalib/utils/util.py:522``
END_LIST = np.array([17, 22, 27, 42, 48, 31, 36, 68], np.int32) - 1

# 'b' draws red, as the reference's colour table does
_KPT_COLORS = {"r": (255, 0, 0), "g": (0, 255, 0), "b": (255, 0, 0)}


def _draw_disk(img: np.ndarray, x: float, y: float, color, radius: int = 2) -> None:
    """A filled disk (dx² + dy² ≤ r²) clipped to the frame; a center off
    the frame draws nothing."""
    h, w = img.shape[:2]
    xi, yi = int(round(x)), int(round(y))
    if not (0 <= xi < w and 0 <= yi < h):
        return
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx * dx + dy * dy <= radius * radius:
                yy, xx = yi + dy, xi + dx
                if 0 <= yy < h and 0 <= xx < w:
                    img[yy, xx] = color


def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    """A 1-pixel segment; samples off the frame are dropped, as cv2.line
    clips."""
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    xs = np.round(np.linspace(p0[0], p1[0], n))
    ys = np.round(np.linspace(p0[1], p1[1], n))
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep].astype(int), xs[keep].astype(int)] = color


def plot_kpts(image: np.ndarray, kpts: np.ndarray, color: str = "r") -> np.ndarray:
    """``util.py::plot_kpts`` without cv2: a disk of radius 2 a landmark and
    a white segment to the next one within each contour group, in the
    reference's order (disk i, then the line i → i+1 over it); with 4
    columns each point is green where column 3 > 0.5, else blue. image
    (H, W, 3) in 0-255, kpts (68, 2|3|4) in pixels."""
    img = image.copy()
    base = _KPT_COLORS[color]
    for i in range(kpts.shape[0]):
        c = base
        if kpts.shape[1] == 4:
            c = (0, 255, 0) if kpts[i, 3] > 0.5 else (0, 0, 255)
        _draw_disk(img, kpts[i, 0], kpts[i, 1], c)
        if i not in END_LIST and i + 1 < kpts.shape[0]:
            _draw_line(img, kpts[i, :2], kpts[i + 1, :2], (255, 255, 255))
    return img


def plot_verts(image: np.ndarray, kpts: np.ndarray, color: str = "r") -> np.ndarray:
    """``util.py::plot_verts``: disks of radius 1, no lines."""
    img = image.copy()
    for i in range(kpts.shape[0]):
        _draw_disk(img, kpts[i, 0], kpts[i, 1], _KPT_COLORS[color], 1)
    return img


def vis_landmarks(images, landmarks, gt_landmarks=None, color: str = "g",
                  is_scale: bool = True) -> np.ndarray:
    """``util.py::tensor_vis_landmarks`` on the host: images (B, H, W, 3) in
    [0, 1], landmarks (B, 68, 2+) in pixels (``is_scale`` False) or in
    [-1, 1] → the drawn images, (B, H, W, 3) in [0, 1]. ``gt_landmarks``
    in [-1, 1] are drawn as red points."""
    images = np.asarray(images, np.float32)
    landmarks = np.asarray(landmarks, np.float32)
    out = []
    for i in range(images.shape[0]):
        img = images[i] * 255.0
        kpts = landmarks[i]
        if is_scale:
            kpts = kpts * img.shape[0] / 2 + img.shape[0] / 2
        draw = plot_kpts if kpts.shape[0] == 68 else plot_verts
        img = draw(img, kpts, color)
        if gt_landmarks is not None:
            gt = np.asarray(gt_landmarks[i], np.float32)
            img = plot_verts(img, gt * img.shape[0] / 2 + img.shape[0] / 2, "r")
        out.append(img)
    return np.stack(out) / 255.0


def save_gif(frames: List[np.ndarray], path: str, fps: int = 15) -> None:
    """HWC uint8 frames → an animated GIF that loops (the reference's
    ``imageio.mimsave``, ``run_facial_editing.py:191-207``)."""
    from PIL import Image
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(1, int(1000 / fps)), loop=0)


def make_interpolation_chart(g: Generator, a: DirectionMatrix, latent: torch.Tensor, *,
                             truncation: float = 0.7,
                             truncation_latent: Optional[torch.Tensor] = None,
                             num_layers_shift: int = 8,
                             directions: Optional[List[int]] = None,
                             shift_scale: float = 6.0, steps: int = 5,
                             input_is_latent: bool = True) -> List[np.ndarray]:
    """Each direction's shift swept over 2·``steps`` + 1 values in
    [−shift_scale, shift_scale] around ``latent`` (1, n_latent, 512): one
    HWC uint8 frame a value, a strip over the directions
    (``visualization.py:21-73``). Without a mean latent there is no
    truncation."""
    k = a.input_dim
    if truncation_latent is None:
        truncation = 1.0
    if directions is None:
        directions = list(range(k))
    values = np.linspace(-shift_scale, shift_scale, 2 * steps + 1)
    n = len(directions)
    dp = torch.zeros((len(values) * n, k), dtype=torch.float32)
    for i, v in enumerate(values):
        for row, d in enumerate(directions):
            dp[i * n + row, d] = float(v)
    with torch.no_grad():
        shift = direction_matrix_forward(a, dp.to(latent.device))
        codes = latent.expand((len(dp),) + tuple(latent.shape[1:]))
        imgs = generate_image(g, codes, truncation=truncation,
                              truncation_latent=truncation_latent, w_plus=True,
                              num_layers_shift=num_layers_shift, shift_code=shift,
                              input_is_latent=input_is_latent).float().cpu().numpy()
    return [np.concatenate([tensor_to_image(im) for im in imgs[i * n:(i + 1) * n]], axis=1)
            for i in range(len(values))]
