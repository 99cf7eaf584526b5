"""ResNet-50 trunk of the DECA encoders (NCHW, inference batch norm).

Bottleneck blocks [3, 4, 6, 3], a 7x7 stem, global average pool → 2048
features (the fc layer is removed). Modules are named like torchvision's
(``conv1``, ``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0``, …).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn import batch_norm, conv2d, max_pool2d, relu

RESNET50_LAYERS = (3, 4, 6, 3)


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = _conv(cin, planes, 1), nn.BatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), nn.BatchNorm2d(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1), nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if stride != 1 or cin != planes * 4:
            self.downsample = nn.Sequential(_conv(cin, planes * 4, 1),
                                            nn.BatchNorm2d(planes * 4))


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = _conv(3, 64, 7), nn.BatchNorm2d(64)
        cin = 64
        for stage, (blocks, planes, stride) in enumerate(
                zip(RESNET50_LAYERS, (64, 128, 256, 512), (1, 2, 2, 2))):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(cin, planes, stride if b == 0 else 1))
                cin = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))

    def stages(self):
        return [getattr(self, f"layer{i + 1}") for i in range(len(RESNET50_LAYERS))]


def _bottleneck(p: Bottleneck, x: torch.Tensor) -> torch.Tensor:
    s = p.stride
    out = relu(batch_norm(conv2d(x, p.conv1.weight), p.bn1))
    out = relu(batch_norm(conv2d(out, p.conv2.weight, stride=s, padding=1), p.bn2))
    out = batch_norm(conv2d(out, p.conv3.weight), p.bn3)
    if p.downsample is not None:
        res = batch_norm(conv2d(x, p.downsample[0].weight, stride=s), p.downsample[1])
    else:
        res = x
    return relu(out + res)


def resnet50_features(p: ResNet50, x: torch.Tensor) -> torch.Tensor:
    """x: (N, 3, 224, 224) → (N, 2048) pooled features. The pool is a global
    mean (the reference's avgpool(7) on the 7x7 map at 224), so smaller
    inputs also work."""
    out = conv2d(x, p.conv1.weight, stride=2, padding=3)
    out = relu(batch_norm(out, p.bn1))
    out = max_pool2d(out, 3, stride=2, padding=1)
    for layer in p.stages():
        for block in layer:
            out = _bottleneck(block, out)
    return out.mean(dim=(2, 3))
