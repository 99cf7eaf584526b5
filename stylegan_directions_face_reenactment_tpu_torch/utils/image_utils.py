"""Image range conversions and image files (the reference's
``libs/utilities/image_utils.py``; the JAX package's
``utils/image_utils.py``).

Images are NHWC float in [-1, 1] or HWC uint8, as numpy arrays or tensors.
Pillow is imported by the functions that read or write a file, and nowhere
else.
"""

from __future__ import annotations

import numpy as np
import torch

from ..native.imgproc import resize_bilinear_u8


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


def torch_range_1_to_255(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] → [0, 255] with the reference's /(2 + 1e-5)
    (``image_utils.py:87-94``): the full range maps to [0, 254.99873]. The
    paired losses take their images through it."""
    return (torch.clamp(x, -1.0, 1.0) + 1.0) / 2.00001 * 255.0


def torch_range_255_to_1(x):
    """[0, 255] → [-1, 1]."""
    return x / 127.5 - 1.0


def image_to_tensor(img: np.ndarray) -> np.ndarray:
    """HWC uint8 → HWC float32 in [-1, 1]."""
    return np.asarray(img, np.float32) / 127.5 - 1.0


def add_border(img: np.ndarray, color=(255, 0, 0), width: int = 4) -> np.ndarray:
    """A copy of an HWC uint8 image with a ``width``-pixel border of
    ``color`` (``image_utils.py:129-137``)."""
    out = img.copy()
    out[:width], out[-width:] = color, color
    out[:, :width], out[:, -width:] = color, color
    return out


def tensor_to_image(x) -> np.ndarray:
    """NHWC float in [-1, 1] (one image or a batch of one) → HWC uint8,
    truncated as the reference does."""
    x = _np(x)
    if x.ndim == 4:
        x = x[0]
    return np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)


def save_image(x, path: str) -> None:
    """Save a [-1, 1] NHWC image (a batch tiled horizontally) as a file."""
    from PIL import Image
    x = _np(x)
    if x.ndim == 3:
        x = x[None]
    Image.fromarray(np.concatenate([tensor_to_image(im) for im in x], axis=1)).save(path)


def save_u8(img: np.ndarray, path: str) -> None:
    """Save an HWC uint8 image as a file."""
    from PIL import Image
    Image.fromarray(np.ascontiguousarray(img)).save(path)


def load_image(path: str, size: int = None) -> np.ndarray:
    """An image file → HWC uint8 RGB, resized bilinearly to ``size``² when
    given."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if size is not None and img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img)


def grid_row(source: np.ndarray, target: np.ndarray, reenacted: np.ndarray) -> np.ndarray:
    """One [source | target | reenacted] row of HWC uint8 cells
    (``utils_inference.py:20-33``). A cell of another size than the
    target's is resized to it by ``native/imgproc.py::resize_bilinear_u8``:
    that is a generator smaller than the 256 crop, whose frames the grid
    upsamples (larger ones are pooled to 256 by the synthesis)."""
    hw = target.shape[:2]
    cells = [c if c.shape[:2] == hw else resize_bilinear_u8(c[None], hw)[0]
             for c in (source, target, reenacted)]
    return np.concatenate(cells, axis=1)


def generate_grid_image(source, target, reenacted) -> np.ndarray:
    """Row-per-sample :func:`grid_row` grid of [-1, 1] NHWC batches → HWC
    uint8."""
    rows = [grid_row(*(tensor_to_image(im) for im in trio))
            for trio in zip(_np(source), _np(target), _np(reenacted))]
    return np.concatenate(rows, axis=0)
