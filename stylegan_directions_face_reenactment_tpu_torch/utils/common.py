"""Small file helpers (the reference's ``libs/utilities/utils.py``)."""

from __future__ import annotations

import os
from typing import List


def get_image_files(path: str) -> List[str]:
    """The .png / .jpg / .jpeg files of a folder, sorted by name."""
    exts = (".png", ".jpg", ".jpeg")
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.lower().endswith(exts))
