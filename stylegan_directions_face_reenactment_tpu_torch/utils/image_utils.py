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
