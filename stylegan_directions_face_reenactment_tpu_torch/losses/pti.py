"""PTI (pivotal tuning inversion) loss.

PyTorch counterpart of ``stylegan_directions_face_reenactment_tpu/losses/
pti.py`` (the reference's ``PTI/base_coach.py:24-43``: pt_l2_lambda·L2 +
LPIPS) with the hyperparameters of ``PTI/hyperparameters.py``. The
ball-holder locality regulariser (``space_regularizer_loss``), off by
default there, is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .lpips import LPIPS, lpips
from .shape_losses import l2_loss


@dataclasses.dataclass(frozen=True)
class PTIHyperparams:
    """`PTI/hyperparameters.py` defaults."""
    pt_l2_lambda: float = 1.0
    pt_lpips_lambda: float = 1.0
    regulizer_l2_lambda: float = 0.1
    regulizer_lpips_lambda: float = 0.1
    regulizer_alpha: float = 10.0
    latent_ball_num_of_samples: int = 1
    use_locality_regularization: bool = False
    pti_learning_rate: float = 3e-4
    max_pti_steps: int = 350
    lpips_value_threshold: float = 0.06


def pti_loss(lpips_params: LPIPS, generated: torch.Tensor, real: torch.Tensor,
             pt_l2_lambda: float = 100.0, pt_lpips_lambda: float = 1.0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(λ_l2·MSE + λ_lpips·LPIPS, MSE, LPIPS) of NHWC images in [-1, 1]
    (`base_coach.py:24-43`; optimize_g uses λ_l2 = 100 for the partial
    tune, `optimization.py:36-40`)."""
    l2 = l2_loss(real, generated)
    lp = lpips(lpips_params, generated, real)
    return pt_l2_lambda * l2 + pt_lpips_lambda * lp, l2, lp
