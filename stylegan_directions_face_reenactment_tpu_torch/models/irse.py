"""IR-SE residual blocks, the body of the e4e inversion encoder, NCHW.

PyTorch counterpart of ``stylegan_directions_face_reenactment_tpu/models/
irse.py`` (the reference's ``encoder4editing/helpers.py``). The modules hold
the parameters under the reference's names (``input_layer.N``,
``body.N.res_layer.N``, ``body.N.shortcut_layer.N``), so a reference
checkpoint loads with ``load_state_dict``; the functions hold the forward
math, frozen as in the reference (batch norm on its running statistics,
folded at call time). :class:`Backbone` is the ArcFace IR-SE-50 of the
identity loss (``model_irse.py:9-48``): the same stem and body, then its
output head.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from .nn import (adaptive_avg_pool2d, batch_norm, conv2d, linear, prelu,
                 relu, sigmoid)

# [3, 4, 14, 3] IR bottleneck stages as (in_c, depth, stride) a block
# (`helpers.py:30-37`)
IRSE50_BLOCKS: List[Tuple[int, int, int]] = []
for _in_c, _depth, _n_units in ((64, 64, 3), (64, 128, 4), (128, 256, 14),
                                (256, 512, 3)):
    IRSE50_BLOCKS.append((_in_c, _depth, 2))
    IRSE50_BLOCKS.extend((_depth, _depth, 1) for _ in range(_n_units - 1))


class SEModule(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)


class BottleneckIRSE(nn.Module):
    """bottleneck_IR_SE: BN → 3×3 conv → PReLU → 3×3 conv (stride) → BN →
    SE, plus a shortcut: the input (a strided pick at stride 2, the
    reference's ``MaxPool2d(1, stride)``) when the widths agree, else a
    strided 1×1 conv and BN."""

    def __init__(self, in_c: int, depth: int, stride: int):
        super().__init__()
        self.in_c, self.depth, self.stride = in_c, depth, stride
        if in_c == depth:
            self.shortcut_layer = nn.MaxPool2d(1, stride)
        else:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(in_c, depth, 1, stride, bias=False), nn.BatchNorm2d(depth))
        self.res_layer = nn.Sequential(
            nn.BatchNorm2d(in_c), nn.Conv2d(in_c, depth, 3, 1, 1, bias=False),
            nn.PReLU(depth), nn.Conv2d(depth, depth, 3, stride, 1, bias=False),
            nn.BatchNorm2d(depth), SEModule(depth))


def input_layer_module() -> nn.Sequential:
    """The stem: 3×3 conv 3 → 64, BN, PReLU."""
    return nn.Sequential(nn.Conv2d(3, 64, 3, 1, 1, bias=False), nn.BatchNorm2d(64),
                         nn.PReLU(64))


def ir_body_module() -> nn.Sequential:
    return nn.Sequential(*[BottleneckIRSE(i, d, s) for i, d, s in IRSE50_BLOCKS])


def se_module(m: SEModule, x: torch.Tensor) -> torch.Tensor:
    """Squeeze-and-excitation (`helpers.py:57-73`)."""
    s = adaptive_avg_pool2d(x, (1, 1))
    s = relu(conv2d(s, m.fc1.weight))
    s = sigmoid(conv2d(s, m.fc2.weight))
    return x * s


def bottleneck_ir(m: BottleneckIRSE, x: torch.Tensor) -> torch.Tensor:
    """bottleneck_IR_SE (`helpers.py:76-120`)."""
    if m.in_c == m.depth:
        shortcut = x if m.stride == 1 else x[:, :, ::m.stride, ::m.stride]
    else:
        sc = m.shortcut_layer
        shortcut = batch_norm(conv2d(x, sc[0].weight, stride=m.stride), sc[1])
    r = m.res_layer
    res = batch_norm(x, r[0])
    res = conv2d(res, r[1].weight, padding=1)
    res = prelu(res, r[2].weight)
    res = conv2d(res, r[3].weight, stride=m.stride, padding=1)
    res = batch_norm(res, r[4])
    res = se_module(r[5], res)
    return res + shortcut


def input_layer(m: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    return prelu(batch_norm(conv2d(x, m[0].weight, padding=1), m[1]), m[2].weight)


def ir_body(body: nn.Sequential, x: torch.Tensor,
            taps: Tuple[int, ...] = ()) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Run the 24 blocks, returning the output and the outputs of the blocks
    in ``taps`` (e4e taps blocks 6/20/23, `psp_encoders.py:175-182`)."""
    tapped = []
    for i, blk in enumerate(body):
        x = bottleneck_ir(blk, x)
        if i in taps:
            tapped.append(x)
    return x, tapped


class Backbone(nn.Module):
    """ArcFace IR-SE-50 at 112 (``model_irse.py:9-48``): ``input_layer``,
    ``body`` and ``output_layer`` = BN2d(512) → Dropout → Flatten →
    Linear(512·7·7 → 512) → BN1d(512, affine=False), under the reference's
    keys (``output_layer.{0,3,4}``)."""

    def __init__(self, input_size: int = 112):
        super().__init__()
        spatial = input_size // 16
        self.input_layer = input_layer_module()
        self.body = ir_body_module()
        self.output_layer = nn.Sequential(
            nn.BatchNorm2d(512), nn.Dropout(), nn.Flatten(),
            nn.Linear(512 * spatial * spatial, 512), nn.BatchNorm1d(512, affine=False))


def l2_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / ||x|| (``helpers.py:16-19``)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)


def backbone_forward(m: Backbone, x: torch.Tensor) -> torch.Tensor:
    """x (B, 112, 112, 3) in [-1, 1] → (B, 512) unit embedding. Dropout is
    the identity (frozen); the flatten is in (C, H, W) order, so the
    reference's Linear applies unchanged."""
    out = input_layer(m.input_layer, x.permute(0, 3, 1, 2))
    out, _ = ir_body(m.body, out)
    head = m.output_layer
    out = batch_norm(out, head[0]).flatten(1)
    out = batch_norm(linear(out, head[3].weight, head[3].bias), head[4])
    return l2_norm(out)
