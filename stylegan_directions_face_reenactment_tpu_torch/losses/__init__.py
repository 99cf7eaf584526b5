"""Losses: LPIPS (AlexNet) and the PTI objective of source set-up."""

from .lpips import LPIPS, alex_features, lpips
from .pti import PTIHyperparams, pti_loss
from .shape_losses import l2_loss

__all__ = ["LPIPS", "alex_features", "lpips", "PTIHyperparams", "pti_loss",
           "l2_loss"]
