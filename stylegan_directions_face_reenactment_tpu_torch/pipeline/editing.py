"""Single-attribute facial editing: direction sweeps (the reference's
``run_facial_editing.py:158-207``; the JAX package's ``pipeline/editing.py``).

For one direction, the shift sweeps from −shift_scale − start to
shift_scale − start in steps of shift_scale / ``shifts_count`` (0.6 at the
defaults, about 20 steps), one image a step. The whole sweep is one
batched synthesis.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry.directions import DirectionsSpec, get_direction_info
from ..models.direction_matrix import DirectionMatrix, direction_matrix_forward
from ..models.stylegan2 import Generator
from .synthesis import generate_image


def one_hot_shift(k: int, direction_index: int, values: torch.Tensor) -> torch.Tensor:
    """(S,) sweep values → (S, k) Δp rows, ``values`` in column
    ``direction_index`` and zeros elsewhere (``libs/utilities/utils.py:62-65``)."""
    out = torch.zeros((values.shape[0], k), dtype=torch.float32, device=values.device)
    out[:, direction_index] = values.float()
    return out


def sweep_direction(g: Generator, a: DirectionMatrix, spec: DirectionsSpec,
                    source_code: torch.Tensor, direction_index: int,
                    params_source: Dict[str, np.ndarray], angles_source: np.ndarray, *,
                    shifts_count: int = 10, truncation: float = 0.7,
                    truncation_latent: Optional[torch.Tensor] = None,
                    num_layers_shift: int = 8, input_is_latent: bool = True
                    ) -> Tuple[str, np.ndarray, torch.Tensor]:
    """Sweep one direction for one source W+ code (1, n_latent, 512) on its
    device: (direction name, shift values (S,), images (S, H, W, 3) in
    [-1, 1], H = min(size, 256))."""
    name, _, mn, mx, step = get_direction_info(spec, direction_index, params_source,
                                               angles_source, shifts_count=shifts_count)
    values = np.arange(mn, mx, step, dtype=np.float32)
    dp = one_hot_shift(spec.learned_directions, direction_index,
                       torch.from_numpy(values).to(source_code.device))
    shift = direction_matrix_forward(a, dp)                       # (S, L, 512)
    codes = source_code.expand((len(values),) + tuple(source_code.shape[1:]))
    imgs = generate_image(g, codes, truncation=truncation,
                          truncation_latent=truncation_latent, w_plus=True,
                          num_layers_shift=num_layers_shift, shift_code=shift,
                          input_is_latent=input_is_latent)
    return name, values, imgs
