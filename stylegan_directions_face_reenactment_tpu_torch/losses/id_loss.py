"""Identity loss through the ArcFace IR-SE-50 embedding (the reference's
``libs/criteria/id_loss.py``; the JAX package's ``losses/id_loss.py``):
crop the face region (rows 35:223, columns 32:220 of the 256 image), pool
it to 112, embed, and take 1 − the cosine similarity, averaged over the
batch. The same embedding gives the CSIM evaluation metric
(``utils_train.py:729-731``).
"""

from __future__ import annotations

import torch

from ..models.irse import Backbone, backbone_forward
from ..models.nn import adaptive_avg_pool2d


def extract_id_feats(backbone: Backbone, x: torch.Tensor, crop: bool = True) -> torch.Tensor:
    """x (B, 256, 256, 3) in [-1, 1] → (B, 512) unit embeddings
    (``id_loss.py:20-25``)."""
    if crop:
        x = x[:, 35:223, 32:220, :]
    x = adaptive_avg_pool2d(x.permute(0, 3, 1, 2), (112, 112)).permute(0, 2, 3, 1)
    return backbone_forward(backbone, x)


def id_loss(backbone: Backbone, y_hat: torch.Tensor, y: torch.Tensor,
            crop: bool = True) -> torch.Tensor:
    """mean(1 − cos(feat(y_hat), feat(y))); y's features are constants
    (``id_loss.py:27-34``)."""
    fy = extract_id_feats(backbone, y, crop).detach()
    fyh = extract_id_feats(backbone, y_hat, crop)
    return torch.mean(1.0 - torch.sum(fy * fyh, dim=-1))   # the embeddings are unit


def csim(backbone: Backbone, y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The cosine-similarity metric, 1 − :func:`id_loss`."""
    return 1.0 - id_loss(backbone, y_hat, y)
