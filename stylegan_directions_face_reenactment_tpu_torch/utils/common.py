"""Small helpers (the reference's ``libs/utilities/utils.py``; the JAX
package's ``utils/common.py``)."""

from __future__ import annotations

import json
import os
from typing import List, Optional

import torch


def make_noise(gen: torch.Generator, batch: int, dim: int,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """A standard-normal z batch (``utils.py:54-60``) from ``gen`` (in place
    of the JAX package's key), on ``device`` (the generator's by default)."""
    z = torch.randn((batch, dim), generator=gen, device=gen.device)
    return z if device is None else z.to(device)


def one_hot(dims: int, value: float, index: int) -> torch.Tensor:
    """A (1, dims) float32 vector holding ``value`` at ``index``
    (``utils.py:62-65``)."""
    out = torch.zeros((1, dims), dtype=torch.float32)
    out[0, index] = value
    return out


def make_path(path: str) -> str:
    """``path``, made with its parents if missing."""
    os.makedirs(path, exist_ok=True)
    return path


def save_arguments_json(args, save_path: str, filename: str = "arguments.json") -> None:
    """An argparse namespace (or a dict) as indented JSON in ``save_path``."""
    make_path(save_path)
    d = vars(args) if not isinstance(args, dict) else args
    with open(os.path.join(save_path, filename), "w") as f:
        json.dump(d, f, indent=2, default=str)


def get_image_files(path: str) -> List[str]:
    """The .png / .jpg / .jpeg files of a folder, sorted by name."""
    exts = (".png", ".jpg", ".jpeg")
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.lower().endswith(exts))
