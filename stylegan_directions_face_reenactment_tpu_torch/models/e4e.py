"""e4e (encoder4editing) inversion encoder: image → W+ latent.

PyTorch counterpart of ``stylegan_directions_face_reenactment_tpu/models/
e4e.py`` (the reference's ``encoder4editing/psp_encoders.py``): the IR-SE-50
body with feature-pyramid taps at blocks 6/20/23, one "gradual style" head a
W+ row, and e4e's progressive scheme, w0 plus a delta a row (the inference
stage, every delta on). :class:`Encoder4Editing` holds the parameters under
the reference's names (``input_layer``, ``body``, ``styles.N.convs.N``,
``styles.N.linear``, ``latlayer1``, ``latlayer2``); :func:`e4e_forward`
holds the math. The two pSp heads, which the pipeline does not use, sit
beside it on the same IR-SE trunk: :class:`GradualStyleEncoder` (every
style from its own head, no w0 + delta) and
:class:`BackboneEncoderUsingLastLayerIntoW` (the trunk's last map pooled
into one W).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops import equal_linear
from .irse import input_layer, input_layer_module, ir_body, ir_body_module
from .nn import adaptive_avg_pool2d, conv2d, leaky_relu, resize_bilinear
from .stylegan2 import EqualLinear

COARSE_IND = 3
MIDDLE_IND = 7
TAPS = (6, 20, 23)  # c1 (128 ch, 1/4 size), c2 (256 ch, 1/8), c3 (512 ch, 1/16)


def _style_spatial(i: int) -> int:
    if i < COARSE_IND:
        return 16
    if i < MIDDLE_IND:
        return 32
    return 64


class GradualStyleBlock(nn.Module):
    """log2(spatial) stride-2 3×3 convs, each followed by LeakyReLU(0.01),
    then an equalized linear (`psp_encoders.py:33-54`)."""

    def __init__(self, in_c: int, out_c: int, spatial: int):
        super().__init__()
        layers = [nn.Conv2d(in_c, out_c, 3, 2, 1), nn.LeakyReLU()]
        for _ in range(int(math.log2(spatial)) - 1):
            layers += [nn.Conv2d(out_c, out_c, 3, 2, 1), nn.LeakyReLU()]
        self.convs = nn.Sequential(*layers)
        self.linear = EqualLinear(out_c, out_c)


class Encoder4Editing(nn.Module):
    """Encoder4Editing(50, 'ir_se') for a generator of ``image_resolution``
    (`psp_encoders.py:122-161`): 2·log2(resolution) − 2 style heads."""

    def __init__(self, image_resolution: int = 256):
        super().__init__()
        self.style_count = 2 * int(math.log2(image_resolution)) - 2
        self.input_layer = input_layer_module()
        self.body = ir_body_module()
        self.styles = nn.ModuleList(GradualStyleBlock(512, 512, _style_spatial(i))
                                    for i in range(self.style_count))
        self.latlayer1 = nn.Conv2d(256, 512, 1)
        self.latlayer2 = nn.Conv2d(128, 512, 1)

    def forward(self, x):
        return e4e_forward(self, x)


def gradual_style_block(m: GradualStyleBlock, x: torch.Tensor) -> torch.Tensor:
    for conv in m.convs[0::2]:
        x = leaky_relu(conv2d(x, conv.weight, conv.bias, stride=2, padding=1), 0.01)
    return equal_linear(x.reshape(x.shape[0], -1), m.linear.weight, m.linear.bias)


def upsample_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear (align_corners=True) upsample of x to y's size, then add
    (`helpers.py:123-140`)."""
    return resize_bilinear(x, y.shape[2:], align_corners=True) + y


def e4e_forward(e: Encoder4Editing, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 3) in [-1, 1] (256² in the pipeline) → W+ (B, style_count,
    512) (`psp_encoders.py:171-199`, the inference stage: every delta)."""
    x = input_layer(e.input_layer, x.permute(0, 3, 1, 2))
    _, (c1, c2, c3) = ir_body(e.body, x, taps=TAPS)

    w0 = gradual_style_block(e.styles[0], c3)
    deltas = [torch.zeros_like(w0)]
    features, p2 = c3, None
    for i in range(1, e.style_count):
        if i == COARSE_IND:
            p2 = upsample_add(c3, conv2d(c2, e.latlayer1.weight, e.latlayer1.bias))
            features = p2
        elif i == MIDDLE_IND:
            features = upsample_add(p2, conv2d(c1, e.latlayer2.weight, e.latlayer2.bias))
        deltas.append(gradual_style_block(e.styles[i], features))
    return w0[:, None, :] + torch.stack(deltas, dim=1)


class GradualStyleEncoder(Encoder4Editing):
    """pSp's GradualStyleEncoder (``psp_encoders.py:57-120``): e4e's
    parameters and keys, every style from its own head."""

    def forward(self, x):
        return gradual_style_encoder_forward(self, x)


def gradual_style_encoder_forward(e: Encoder4Editing, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 3) in [-1, 1] → W+ (B, style_count, 512), all styles
    independent (``psp_encoders.py:94-120``)."""
    x = input_layer(e.input_layer, x.permute(0, 3, 1, 2))
    _, (c1, c2, c3) = ir_body(e.body, x, taps=TAPS)
    latents = [gradual_style_block(e.styles[j], c3) for j in range(COARSE_IND)]
    p2 = upsample_add(c3, conv2d(c2, e.latlayer1.weight, e.latlayer1.bias))
    latents += [gradual_style_block(e.styles[j], p2) for j in range(COARSE_IND, MIDDLE_IND)]
    p1 = upsample_add(p2, conv2d(c1, e.latlayer2.weight, e.latlayer2.bias))
    latents += [gradual_style_block(e.styles[j], p1)
                for j in range(MIDDLE_IND, e.style_count)]
    return torch.stack(latents, dim=1)


class BackboneEncoderUsingLastLayerIntoW(nn.Module):
    """pSp's BackboneEncoderUsingLastLayerIntoW (``psp_encoders.py:201-232``):
    ``input_layer``, ``body`` and an equalized ``linear`` 512 → 512."""

    def __init__(self):
        super().__init__()
        self.input_layer = input_layer_module()
        self.body = ir_body_module()
        self.linear = EqualLinear(512, 512)

    def forward(self, x):
        return backbone_encoder_into_w_forward(self, x)


def backbone_encoder_into_w_forward(e: BackboneEncoderUsingLastLayerIntoW,
                                    x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 3) in [-1, 1] → W (B, 512): the trunk's last map,
    average-pooled to 1×1, through the linear."""
    x = input_layer(e.input_layer, x.permute(0, 3, 1, 2))
    x, _ = ir_body(e.body, x)
    x = adaptive_avg_pool2d(x, (1, 1)).reshape(x.shape[0], 512)
    return equal_linear(x, e.linear.weight, e.linear.bias)
