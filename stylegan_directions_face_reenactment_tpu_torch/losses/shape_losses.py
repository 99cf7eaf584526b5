"""Image and shape losses (the JAX package's ``losses/shape_losses.py``).
Only the MSE that PTI uses is ported yet; the FLAME shape losses come with
the training path."""

from __future__ import annotations

import torch


def l2_loss(real: torch.Tensor, generated: torch.Tensor) -> torch.Tensor:
    """Mean squared error (`l2_loss.py:6-8`), used by PTI."""
    return torch.mean(torch.square(real - generated))
