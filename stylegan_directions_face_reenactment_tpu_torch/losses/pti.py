"""PTI (pivotal tuning inversion) loss.

PyTorch counterpart of ``stylegan_directions_face_reenactment_tpu/losses/
pti.py`` (the reference's ``PTI/base_coach.py:24-43``: pt_l2_lambda·L2 +
LPIPS) with the hyperparameters of ``PTI/hyperparameters.py``, and the
ball-holder locality regulariser (``localitly_regulizer.py``,
:func:`space_regularizer_loss`), off by default there and in the pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

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


def get_morphed_w_code(new_w: torch.Tensor, fixed_w: torch.Tensor,
                       alpha: float = 10.0) -> torch.Tensor:
    """fixed_w + α·(new − fixed) / ‖new − fixed‖ (``localitly_regulizer.py:15-22``;
    the norm over every element)."""
    direction = new_w - fixed_w
    return fixed_w + alpha * direction / torch.linalg.vector_norm(direction)


def latent_ball_draws(gen: torch.Generator, n: int, dim: int) -> torch.Tensor:
    """The regulariser's ``n`` normal (1, dim) draws from ``gen``, (n, 1, dim)
    on the generator's device."""
    return torch.randn((n, 1, dim), generator=gen, device=gen.device)


def space_regularizer_loss(generator_forward: Callable, new_g, original_g, lpips_params: LPIPS,
                           w_batch: torch.Tensor, gen: torch.Generator,
                           hp: PTIHyperparams = PTIHyperparams()) -> torch.Tensor:
    """The ball-holder locality regulariser (``localitly_regulizer.py:27-54``):
    latents drawn near the pivot ``w_batch`` (:func:`latent_ball_draws`
    from ``gen``, in place of the JAX package's ``rng``), the tuned
    generator's drift from the original there, as λ·MSE + λ·LPIPS, averaged
    over the draws. ``generator_forward(g, w_code)`` returns the image for a
    (1, 512) or W+ code; the original generator's images are constants to
    autograd."""
    draws = latent_ball_draws(gen, hp.latent_ball_num_of_samples, w_batch.shape[-1])
    total = torch.zeros((), device=w_batch.device)
    for z in draws:
        w_morphed = get_morphed_w_code(z.to(w_batch.device), w_batch, hp.regulizer_alpha)
        new_img = generator_forward(new_g, w_morphed)
        with torch.no_grad():
            old_img = generator_forward(original_g, w_morphed)
        if hp.regulizer_l2_lambda > 0:
            total = total + hp.regulizer_l2_lambda * l2_loss(old_img, new_img)
        if hp.regulizer_lpips_lambda > 0:
            total = total + hp.regulizer_lpips_lambda * lpips(lpips_params, old_img, new_img)
    return total / hp.latent_ball_num_of_samples
