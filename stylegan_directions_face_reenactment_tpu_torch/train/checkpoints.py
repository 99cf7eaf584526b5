"""Resuming training from A's file (the reference's
``utils_train.py:578-589``; the JAX package's ``train/checkpoints.py``).
The file itself is ``weights/a_matrix.py``'s; its ``save_a_matrix`` and
``load_a_matrix`` are re-exported here, where the JAX package has them.

One deviation, on purpose, as in the JAX package: the reference's resume
tests ``step in state_dict`` with step = 0 instead of ``'step' in ...``
(``utils_train.py:585``), so a resumed run restarts at step 0; here the
step is recovered.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from ..models.direction_matrix import DirectionMatrix
from ..utils.device import DeviceLike
from ..weights.a_matrix import load_a_matrix, save_a_matrix  # noqa: F401  (re-exported)


def start_from_checkpoint(resume_path: Optional[str], device: DeviceLike = None
                          ) -> Tuple[int, Optional[DirectionMatrix]]:
    """(step, A) of ``resume_path``, or (0, None) when there is no such file
    (``utils_train.py:578-589`` with the step recovered)."""
    if resume_path is None or not os.path.isfile(resume_path):
        return 0, None
    step, a, _ = load_a_matrix(resume_path, device)
    return step, a
