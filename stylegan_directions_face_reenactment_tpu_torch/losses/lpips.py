"""LPIPS perceptual distance (AlexNet trunk, v0.1 linear heads), NCHW inside.

PyTorch counterpart of ``stylegan_directions_face_reenactment_tpu/losses/
lpips.py`` (the reference's ``criteria/lpips/``): z-score the [-1, 1]
inputs, run AlexNet's features, tap after each of the 5 ReLUs, normalize
each tap per position over its channels, square the difference, apply the
frozen 1×1 linear heads, take the spatial mean, and sum over layers and
batch divided by the batch (`lpips.py:28-34`: a sum over layers, not a
mean).

:class:`LPIPS` holds the weights under the reference's names: ``net.layers``
is torchvision's ``alexnet().features`` (convs at 0, 3, 6, 8, 10) and
``lin`` the heads (``lin.N.1.weight``), so the two state dicts the JAX
package's ``convert_lpips_alex`` takes are ``net.layers.state_dict()`` and
``lin.state_dict()``. Its parameters are frozen (``requires_grad`` False) as
the reference's are: gradients flow to the images only.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from ..models.nn import conv2d, max_pool2d, relu

# torchvision alexnet.features: (out_ch, k, stride, pad) a conv
ALEX_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
              (256, 3, 1, 1), (256, 3, 1, 1))
# max-pool 3/2 after these convs (torchvision's third pool, after conv 4,
# feeds no tap and is not run)
ALEX_POOL_AFTER = (0, 1)
ALEX_LAYER_IDS = (0, 3, 6, 8, 10)
N_CHANNELS = (64, 192, 384, 256, 256)
_MEAN = (-0.030, -0.088, -0.188)
_STD = (0.458, 0.448, 0.450)


class _AlexFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for i, (cout, k, s, p) in enumerate(ALEX_CONVS):
            layers += [nn.Conv2d(cin, cout, k, s, p), nn.ReLU(inplace=True)]
            if i in (0, 1, 4):
                layers.append(nn.MaxPool2d(3, 2))
            cin = cout
        self.layers = nn.Sequential(*layers)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = _AlexFeatures()
        self.lin = nn.ModuleList(nn.Sequential(nn.Identity(), nn.Conv2d(c, 1, 1, bias=False))
                                 for c in N_CHANNELS)
        self.requires_grad_(False)


def normalize_activation(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """x / (sqrt(Σ_c x² + 1e-9) + eps) over the channel dim 1
    (`lpips/utils.py:6-12`)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True) + 1e-9)
    return x / (norm + eps)


def alex_features(lp: LPIPS, x: torch.Tensor) -> List[torch.Tensor]:
    """x (B, H, W, 3) in [-1, 1] → the 5 normalized taps, each NCHW."""
    x = x.permute(0, 3, 1, 2)
    mean = torch.tensor(_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    x = (x - mean) / std
    taps = []
    for i, ((_, _, s, p), idx) in enumerate(zip(ALEX_CONVS, ALEX_LAYER_IDS)):
        conv = lp.net.layers[idx]
        x = relu(conv2d(x, conv.weight, conv.bias, stride=s, padding=p))
        taps.append(normalize_activation(x))
        if i in ALEX_POOL_AFTER:
            x = max_pool2d(x, 3, stride=2)
    return taps


def lpips(lp: LPIPS, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Scalar LPIPS distance of NHWC batches x and y in [-1, 1], summed over
    layers, averaged over the batch."""
    total = 0.0
    for tx, ty, lin in zip(alex_features(lp, x), alex_features(lp, y), lp.lin):
        r = conv2d(torch.square(tx - ty), lin[1].weight)      # (B, 1, H, W)
        total = total + r.mean(dim=(1, 2, 3)).sum()
    return total / x.shape[0]
