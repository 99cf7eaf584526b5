"""FAN landmark network: the 4-stack hourglass 2DFAN4 → 68 heatmaps.

Counterpart of the JAX package's ``models/face/fan.py`` (the reference's
``libs/face_models/fan_model/models.py``): the dense-residual ConvBlock,
the recursive depth-4 hourglass and the stacked modules, with the
reference checkpoint's key layout (``conv1``, ``bn1``, ``conv2..4``,
``m{i}.b1_4 …``, ``top_m_{i}``, ``conv_last{i}``, ``bn_end{i}``, ``l{i}``,
``bl{i}``/``al{i}`` for every module but the last). The modules run as a
Python loop; the last module has no ``bl``/``al`` (the JAX package zero-
fills them only to share one ``lax.scan`` body, and their result is
discarded). :class:`ResNetDepth` (``fan_model/models.py:205-265``) with
:func:`draw_gaussians` and :func:`predict_depth` gives the 3D landmarks'
depth (``landmarks.py::estimate_landmarks_3d``).

Public functions take and return the JAX layouts (NHWC crops, NHWC
heatmaps (B, 64, 64, 68), (B, 68, 2) points) and compute in NCHW inside.
Every channels-equal 256-channel block goes through K3
(``ops/fused_conv_block.py``) when its gate says so.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from ...ops.fused_conv_block import (args_in_program, conv_block_fused, fused_conv_block,
                                     fused_convblock_enabled)
from ..deca.resnet import Bottleneck, _bottleneck
from ..nn import avg_pool2d, batch_norm, conv2d, linear, max_pool2d, relu, upsample_nearest

HOURGLASS_DEPTH = 4


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class ConvBlock(nn.Module):
    """Dense residual block (``fan_model/models.py:13-55``)."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.bn1, self.conv1 = nn.BatchNorm2d(in_planes), _conv3x3(in_planes, out_planes // 2)
        self.bn2, self.conv2 = (nn.BatchNorm2d(out_planes // 2),
                                _conv3x3(out_planes // 2, out_planes // 4))
        self.bn3, self.conv3 = (nn.BatchNorm2d(out_planes // 4),
                                _conv3x3(out_planes // 4, out_planes // 4))
        self.downsample = None
        if in_planes != out_planes:
            self.downsample = nn.Sequential(nn.BatchNorm2d(in_planes), nn.ReLU(True),
                                            nn.Conv2d(in_planes, out_planes, 1, bias=False))


class HourGlass(nn.Module):
    """Recursive hourglass (``fan_model/models.py:98-142``): per level
    ``b1_L``, ``b2_L``, ``b3_L``, and ``b2_plus_1`` at the bottom."""

    def __init__(self, depth: int = HOURGLASS_DEPTH, features: int = 256):
        super().__init__()
        self.depth = depth
        for level in range(depth, 0, -1):
            for name in ("b1", "b2", "b3"):
                self.add_module(f"{name}_{level}", ConvBlock(features, features))
            if level == 1:
                self.add_module("b2_plus_1", ConvBlock(features, features))


class FAN(nn.Module):
    def __init__(self, num_modules: int = 4):
        super().__init__()
        self.num_modules = num_modules
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for m in range(num_modules):
            self.add_module(f"m{m}", HourGlass())
            self.add_module(f"top_m_{m}", ConvBlock(256, 256))
            self.add_module(f"conv_last{m}", nn.Conv2d(256, 256, 1))
            self.add_module(f"bn_end{m}", nn.BatchNorm2d(256))
            self.add_module(f"l{m}", nn.Conv2d(256, 68, 1))
            if m < num_modules - 1:
                self.add_module(f"bl{m}", nn.Conv2d(256, 256, 1))
                self.add_module(f"al{m}", nn.Conv2d(68, 256, 1))


def conv_block(p: ConvBlock, x: torch.Tensor) -> torch.Tensor:
    """x (B, Cin, H, W) → (B, Cout, H, W): K3 for the blocks of a program
    (with the program's own folds and packed weights, on every device) and
    for those its gate takes, else the plain composition."""
    args = args_in_program(p)
    if args is not None:
        return fused_conv_block(x, args)
    if fused_convblock_enabled(p, x):
        return conv_block_fused(p, x)
    out1 = conv2d(relu(batch_norm(x, p.bn1)), p.conv1.weight, padding=1)
    out2 = conv2d(relu(batch_norm(out1, p.bn2)), p.conv2.weight, padding=1)
    out3 = conv2d(relu(batch_norm(out2, p.bn3)), p.conv3.weight, padding=1)
    out = torch.cat([out1, out2, out3], dim=1)
    if p.downsample is not None:
        res = conv2d(relu(batch_norm(x, p.downsample[0])), p.downsample[2].weight)
    else:
        res = x
    return out + res


def hourglass(p: HourGlass, x: torch.Tensor) -> torch.Tensor:
    def recurse(level, inp):
        up1 = conv_block(getattr(p, f"b1_{level}"), inp)
        low1 = conv_block(getattr(p, f"b2_{level}"), avg_pool2d(inp, 2, stride=2))
        if level > 1:
            low2 = recurse(level - 1, low1)
        else:
            low2 = conv_block(p.b2_plus_1, low1)
        low3 = conv_block(getattr(p, f"b3_{level}"), low2)
        return up1 + upsample_nearest(low3, 2)

    return recurse(p.depth, x)


def _conv1x1(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv2d(x, m.weight, m.bias)


def fan_forward(p: FAN, x: torch.Tensor) -> List[torch.Tensor]:
    """x (B, 256, 256, 3) in [0, 1] → one heatmap batch (B, 64, 64, 68) per
    stacked module (``fan_model/models.py:174-202``); use the last. The
    heatmaps are NHWC views of NCHW tensors."""
    x = x.permute(0, 3, 1, 2)
    x = relu(batch_norm(conv2d(x, p.conv1.weight, p.conv1.bias, stride=2, padding=3),
                        p.bn1))
    x = avg_pool2d(conv_block(p.conv2, x), 2, stride=2)
    x = conv_block(p.conv3, x)
    previous = conv_block(p.conv4, x)
    outs = []
    for m in range(p.num_modules):
        hg = hourglass(getattr(p, f"m{m}"), previous)
        ll = conv_block(getattr(p, f"top_m_{m}"), hg)
        ll = relu(batch_norm(_conv1x1(getattr(p, f"conv_last{m}"), ll),
                             getattr(p, f"bn_end{m}")))
        tmp_out = _conv1x1(getattr(p, f"l{m}"), ll)
        outs.append(tmp_out.permute(0, 2, 3, 1))
        if m < p.num_modules - 1:
            previous = (previous + _conv1x1(getattr(p, f"bl{m}"), ll)
                        + _conv1x1(getattr(p, f"al{m}"), tmp_out))
    return outs


def heatmaps_to_landmarks(hm: torch.Tensor) -> torch.Tensor:
    """(B, 64, 64, 68) heatmaps → (B, 68, 2) sub-pixel peaks in heatmap
    units: the first maximum in row-major order (+1, the reference works
    1-based), ±0.25 toward the larger neighbour for interior peaks, then
    −0.5 (``landmarks_estimation.py:50-88``)."""
    b, h, w, n = hm.shape
    flat = hm.permute(0, 3, 1, 2).reshape(b, n, h * w)           # (B, 68, H·W)
    idx = torch.argmax(flat, dim=-1)                             # first maximum
    py, px = idx // w, idx % w

    def gather(dy, dx):
        yy = (py + dy).clamp(0, h - 1)
        xx = (px + dx).clamp(0, w - 1)
        return torch.gather(flat, 2, (yy * w + xx)[..., None])[..., 0]

    diff_x = gather(0, 1) - gather(0, -1)
    diff_y = gather(1, 0) - gather(-1, 0)
    interior = (px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)
    zero = torch.zeros((), dtype=torch.float32, device=hm.device)
    fx = px.float() + 1.0 + torch.where(interior, torch.sign(diff_x).float() * 0.25, zero)
    fy = py.float() + 1.0 + torch.where(interior, torch.sign(diff_y).float() * 0.25, zero)
    return torch.stack([fx - 0.5, fy - 0.5], dim=-1)


def landmarks_to_image_coords(pts: torch.Tensor, center: torch.Tensor,
                              scale: torch.Tensor, resolution: float = 64.0,
                              truncate: bool = True) -> torch.Tensor:
    """Heatmap-frame points → image coords, the inverse of the 200·scale
    crop (``fan_model/utils.py:63-97``); pts (B, 68, 2), center (B, 2),
    scale (B,). ``truncate`` rounds toward zero as the reference's
    ``.int()`` does (float32 values)."""
    h = 200.0 * scale[:, None, None]
    out = (pts / resolution) * h + (center[:, None, :] - h / 2.0)
    return torch.trunc(out) if truncate else out


# ---------------------------------------------------------------------------
# 3D landmarks: the depth net
# ---------------------------------------------------------------------------

DEPTH_LAYERS = (3, 8, 36, 3)


class ResNetDepth(nn.Module):
    """ResNetDepth (``fan_model/models.py:205-265``): a bottleneck ResNet
    over the crop and 68 landmark heatmaps (71 channels) → 68 depths, under
    the reference's keys (``conv1``, ``bn1``, ``layer{1..4}.N.*``, ``fc``)."""

    def __init__(self, layers=DEPTH_LAYERS, num_classes: int = 68):
        super().__init__()
        self.conv1 = nn.Conv2d(3 + 68, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for stage, (blocks, planes, stride) in enumerate(
                zip(layers, (64, 128, 256, 512), (1, 2, 2, 2))):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(cin, planes, stride if b == 0 else 1))
                cin = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.fc = nn.Linear(cin, num_classes)


def resnet_depth_forward(p: ResNetDepth, x: torch.Tensor) -> torch.Tensor:
    """x (B, 256, 256, 71) NHWC, the crop and the heatmaps → (B, 68)."""
    out = conv2d(x.permute(0, 3, 1, 2), p.conv1.weight, stride=2, padding=3)
    out = max_pool2d(relu(batch_norm(out, p.bn1)), 3, stride=2, padding=1)
    for i in range(1, 5):
        for block in getattr(p, f"layer{i}"):
            out = _bottleneck(block, out)
    out = avg_pool2d(out, 7)
    return linear(out.reshape(out.shape[0], -1), p.fc.weight, p.fc.bias)


def draw_gaussians(points: torch.Tensor, size: int = 256, sigma: float = 2.0) -> torch.Tensor:
    """One gaussian heatmap a landmark, batched (the reference's
    ``draw_gaussian`` loop, ``fan_model/utils.py:39-61``): the peak at the
    1-based point, clipped at 1; landmarks with x <= 0 are skipped
    (``landmarks_estimation.py:169``). points (B, L, 2) → (B, size, size, L)."""
    grid = torch.arange(1, size + 1, dtype=torch.float32, device=points.device)
    gy = grid[None, :, None, None] - points[:, None, None, :, 1]
    gx = grid[None, None, :, None] - points[:, None, None, :, 0]
    g = torch.exp(-(gy ** 2 + gx ** 2) / (2.0 * sigma ** 2))
    valid = (points[:, None, None, :, 0] > 0).to(g.dtype)
    return torch.clamp_max(g * valid, 1.0)


def predict_depth(depth: ResNetDepth, crops01: torch.Tensor, pts_hm: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """The 3D landmarks' depths (``landmarks_estimation.py:165-181``): crops01
    (B, 256, 256, 3) in [0, 1], pts_hm (B, 68, 2) heatmap-frame peaks,
    scale (B,) → (B, 68) depths in image units (depth · 200·scale / 256)."""
    heat = draw_gaussians(pts_hm * 4.0, size=256, sigma=2.0)
    out = resnet_depth_forward(depth, torch.cat([crops01.to(heat.dtype), heat], dim=-1))
    return out * (200.0 * scale[:, None] / 256.0)
