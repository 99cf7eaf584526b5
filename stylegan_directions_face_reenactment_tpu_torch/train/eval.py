"""Evaluation metrics: CSIM, pose error and the normalized expression error
(the reference's ``utils_train.py:695-732``; the JAX package's
``train/eval.py``). The reference measures only sample 0 of each validation
batch (``:697-707``); here the whole batch counts unless ``batch0_only``
asks for the reference's reading.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..geometry.directions import DirectionsSpec
from ..losses.id_loss import id_loss
from ..models.irse import Backbone

Coeffs = Dict[str, torch.Tensor]


def expression_error(spec: DirectionsSpec, params_shifted: Coeffs, params_target: Coeffs
                     ) -> torch.Tensor:
    """Mean |Δ| of the coefficients normalized to their ranges over the
    learned expressions and the jaw (``utils_train.py:709-722``). (B,)."""
    errs = []
    for j in range(spec.num_expressions):
        lo, hi = spec.exp_min[j], spec.exp_max[j]
        # the reference indexes the expression coefficients by j (`:714-715`)
        t = (params_target["alpha_exp"][:, j] - lo) / (hi - lo)
        s = (params_shifted["alpha_exp"][:, j] - lo) / (hi - lo)
        errs.append(torch.abs(s - t))
    span = spec.jaw_max - spec.jaw_min
    t = (params_target["pose"][:, 3] - spec.jaw_min) / span
    s = (params_shifted["pose"][:, 3] - spec.jaw_min) / span
    errs.append(torch.abs(s - t))
    return torch.stack(errs, dim=-1).mean(dim=-1)


def pose_error(angles_shifted: torch.Tensor, angles_target: torch.Tensor) -> torch.Tensor:
    """Mean |Δ angle| over yaw, pitch and roll, in degrees (``:724-725``). (B,)."""
    return torch.abs(angles_shifted - angles_target).mean(dim=-1)


def extract_evaluation_metrics(spec: DirectionsSpec, id_backbone: Backbone,
                               params_shifted: Coeffs, params_target: Coeffs,
                               angles_shifted: torch.Tensor, angles_target: torch.Tensor,
                               imgs_shifted: torch.Tensor, imgs_source: torch.Tensor, *,
                               batch0_only: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(csim, pose error, expression error), scalars over the batch, or over
    sample 0 with ``batch0_only`` (whose CSIM still takes the whole batch,
    as the reference's does, ``:729``)."""
    if batch0_only:
        params_shifted = {k: v[:1] for k, v in params_shifted.items()}
        params_target = {k: v[:1] for k, v in params_target.items()}
        angles_shifted, angles_target = angles_shifted[:1], angles_target[:1]
    exp_err = expression_error(spec, params_shifted, params_target).mean()
    pose_err = pose_error(angles_shifted, angles_target).mean()
    csim = 1.0 - id_loss(id_backbone, imgs_shifted, imgs_source)
    return csim, pose_err, exp_err
