"""Losses: LPIPS (AlexNet), the PTI objective of source set-up, the ArcFace
identity loss and the FLAME shape losses of training."""

from .id_loss import csim, extract_id_feats, id_loss
from .lpips import LPIPS, alex_features, lpips, normalize_activation
from .pti import PTIHyperparams, get_morphed_w_code, pti_loss, space_regularizer_loss
from .shape_losses import (EYE_PAIRS, MOUTH_PAIRS, eye_loss, l2_loss, mouth_loss,
                           pixel_wise_loss, shape_loss)

__all__ = ["LPIPS", "alex_features", "lpips", "normalize_activation", "PTIHyperparams",
           "pti_loss", "get_morphed_w_code", "space_regularizer_loss",
           "csim", "extract_id_feats", "id_loss", "eye_loss", "l2_loss",
           "mouth_loss", "pixel_wise_loss", "shape_loss", "EYE_PAIRS", "MOUTH_PAIRS"]
