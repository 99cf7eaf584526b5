"""FLAME shape, landmark and pixel losses (the reference's
``libs/criteria/losses.py`` and ``l2_loss.py``; the JAX package's
``losses/shape_losses.py``)."""

from __future__ import annotations

import torch

# landmark index pairs (68-landmark convention), `losses.py:36,53`
EYE_PAIRS = ((36, 39), (37, 41), (38, 40), (42, 45), (43, 47), (44, 46))
MOUTH_PAIRS = ((48, 54), (49, 59), (50, 58), (51, 57), (52, 56), (53, 55),
               (60, 64), (61, 67), (62, 66), (63, 65))


def pixel_wise_loss(images_shifted: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """Mean L1 (`losses.py:14-18`)."""
    return torch.mean(torch.abs(images - images_shifted))


def l2_loss(real: torch.Tensor, generated: torch.Tensor) -> torch.Tensor:
    """Mean squared error (`l2_loss.py:6-8`), used by PTI."""
    return torch.mean(torch.square(real - generated))


def shape_loss(shape_gt: torch.Tensor, shape_reenacted: torch.Tensor,
               normalize: bool = False) -> torch.Tensor:
    """L1 over projected FLAME vertices (`losses.py:20-28`)."""
    if normalize:
        shape_gt = shape_gt / 200.0
        shape_reenacted = shape_reenacted / 200.0
    return torch.mean(torch.abs(shape_gt - shape_reenacted))


def _pair_distance_loss(gt: torch.Tensor, pred: torch.Tensor, pairs) -> torch.Tensor:
    """Mean over pairs, batch and coordinates of the L1 between the
    |lmk_a − lmk_b| distance vectors (`losses.py:30-62`)."""
    idx_a = torch.tensor([p[0] for p in pairs], device=gt.device)
    idx_b = torch.tensor([p[1] for p in pairs], device=gt.device)
    d_gt = torch.abs(gt[:, idx_a, :] - gt[:, idx_b, :])     # (B, P, C)
    d_pr = torch.abs(pred[:, idx_a, :] - pred[:, idx_b, :])
    return torch.mean(torch.abs(d_gt - d_pr))


def eye_loss(landmarks_gt: torch.Tensor, landmarks_pred: torch.Tensor) -> torch.Tensor:
    return _pair_distance_loss(landmarks_gt, landmarks_pred, EYE_PAIRS)


def mouth_loss(landmarks_gt: torch.Tensor, landmarks_pred: torch.Tensor) -> torch.Tensor:
    return _pair_distance_loss(landmarks_gt, landmarks_pred, MOUTH_PAIRS)
