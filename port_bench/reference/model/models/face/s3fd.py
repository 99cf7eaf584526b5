"""S3FD face detector: the VGG anchor network, dense decode and a
fixed-size greedy NMS, batched.

Counterpart of the JAX package's ``models/face/s3fd.py`` (the reference's
``libs/face_models/sfd/``): the VGG trunk and its 6 heads with L2Norm
scaling and max-out background on the stride-4 head, every scale decoded
densely, the top ``top_k`` candidates of each image by a stable sort, and
NMS as a loop over those ``top_k`` slots on batch tensors. Modules keep the
reference checkpoint's key layout (``conv1_1 …``, ``*_mbox_conf``,
``*_mbox_loc``, ``conv{3,4,5}_3_norm.weight``). Public functions take and
return the JAX layouts (NHWC images, NHWC head maps, (B, K, 5) boxes).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from ..nn import conv2d, max_pool2d, relu

# (name, out channels, kernel, stride, pad) of the VGG trunk, `net_s3fd.py:25-50`
TRUNK = (
    ("conv1_1", 64, 3, 1, 1), ("conv1_2", 64, 3, 1, 1),
    ("conv2_1", 128, 3, 1, 1), ("conv2_2", 128, 3, 1, 1),
    ("conv3_1", 256, 3, 1, 1), ("conv3_2", 256, 3, 1, 1), ("conv3_3", 256, 3, 1, 1),
    ("conv4_1", 512, 3, 1, 1), ("conv4_2", 512, 3, 1, 1), ("conv4_3", 512, 3, 1, 1),
    ("conv5_1", 512, 3, 1, 1), ("conv5_2", 512, 3, 1, 1), ("conv5_3", 512, 3, 1, 1),
    ("fc6", 1024, 3, 1, 3), ("fc7", 1024, 1, 1, 0),
    ("conv6_1", 256, 1, 1, 0), ("conv6_2", 512, 3, 2, 1),
    ("conv7_1", 128, 1, 1, 0), ("conv7_2", 256, 3, 2, 1),
)
# (name, in channels, out channels) of the heads, all 3x3 with padding 1
HEADS = (
    ("conv3_3_norm_mbox_conf", 256, 4), ("conv3_3_norm_mbox_loc", 256, 4),
    ("conv4_3_norm_mbox_conf", 512, 2), ("conv4_3_norm_mbox_loc", 512, 4),
    ("conv5_3_norm_mbox_conf", 512, 2), ("conv5_3_norm_mbox_loc", 512, 4),
    ("fc7_mbox_conf", 1024, 2), ("fc7_mbox_loc", 1024, 4),
    ("conv6_2_mbox_conf", 512, 2), ("conv6_2_mbox_loc", 512, 4),
    ("conv7_2_mbox_conf", 256, 2), ("conv7_2_mbox_loc", 256, 4),
)
NORMS = (("conv3_3_norm", 256, 10.0), ("conv4_3_norm", 512, 8.0),
         ("conv5_3_norm", 512, 5.0))
MEAN_BGR_SUB = (104.0, 117.0, 123.0)  # per-channel mean, `sfd/detect.py:21`
_POOL_AFTER = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3")


class L2Norm(nn.Module):
    def __init__(self, channels: int, scale: float):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), scale))


class S3FD(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for name, cout, k, st, pd in TRUNK:
            self.add_module(name, nn.Conv2d(cin, cout, k, stride=st, padding=pd))
            cin = cout
        for name, c_in, cout in HEADS:
            self.add_module(name, nn.Conv2d(c_in, cout, 3, padding=1))
        for name, c, scale in NORMS:
            self.add_module(name, L2Norm(c, scale))


def l2norm_scale(x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-10) -> torch.Tensor:
    """x / ||x||_c · w[c] on dim 1 (``net_s3fd.py:6-19``)."""
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps
    return x / norm * weight.to(x.dtype).view(1, -1, 1, 1)


def s3fd_forward(p: S3FD, x: torch.Tensor) -> List[torch.Tensor]:
    """x (B, H, W, 3), already in the detector's input convention → the 12
    NHWC head maps [cls1, reg1, …, cls6, reg6], cls1 with the max-out
    background applied (``net_s3fd.py:70-129``). The convolutions run
    without cuDNN: its float32 FFT and Winograd algorithms spread rounding
    over regions that are exactly zero, which the L2-normed heads would
    read as content."""
    with torch.backends.cudnn.flags(enabled=False):
        return _s3fd_forward(p, x)


def _s3fd_forward(p: S3FD, x: torch.Tensor) -> List[torch.Tensor]:
    h = x.permute(0, 3, 1, 2)
    feats: Dict[str, torch.Tensor] = {}
    for name, *_ in TRUNK:
        m = getattr(p, name)
        h = relu(conv2d(h, m.weight, m.bias, stride=m.stride[0], padding=m.padding[0]))
        feats[name] = h
        if name in _POOL_AFTER:
            h = max_pool2d(h, 2, 2)
    sources = {"conv3_3_norm": l2norm_scale(feats["conv3_3"], p.conv3_3_norm.weight),
               "conv4_3_norm": l2norm_scale(feats["conv4_3"], p.conv4_3_norm.weight),
               "conv5_3_norm": l2norm_scale(feats["conv5_3"], p.conv5_3_norm.weight),
               "fc7": feats["fc7"], "conv6_2": feats["conv6_2"], "conv7_2": feats["conv7_2"]}
    outs = []
    for name, _, _ in HEADS:
        m = getattr(p, name)
        o = conv2d(sources[name.rsplit("_mbox", 1)[0]], m.weight, m.bias, padding=1)
        if name == "conv3_3_norm_mbox_conf":
            # max-out background: the max of the first 3 channels vs the 4th
            o = torch.cat([o[:, :3].amax(dim=1, keepdim=True), o[:, 3:4]], dim=1)
        outs.append(o.permute(0, 2, 3, 1))
    return outs


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor,
                 variances=(0.1, 0.2)) -> torch.Tensor:
    """SSD box decode (``sfd/bbox.py:93-110``): center offsets → corners."""
    centers = priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    return torch.cat([centers - wh / 2, centers + wh / 2], dim=-1)


_anchor_cache: Dict[Tuple[int, int, int, str], torch.Tensor] = {}


def dense_anchors(h: int, w: int, stride: int,
                  device=None) -> torch.Tensor:
    """Every prior of one scale, (h·w, 4) [cx, cy, w, h]: centers at
    stride/2 + i·stride, side 4·stride (``sfd/detect.py:59-68``). Built once
    per map shape and device, outside inference mode, so that a later call
    with grad on may use them; under ``torch.export`` they are built in the
    traced program and not kept (they would be fake tensors)."""
    dev = torch.device(device if device is not None else "cpu")
    key = (h, w, stride, str(dev))
    if key not in _anchor_cache or torch.compiler.is_exporting():
        with torch.inference_mode(False):
            ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                                    torch.arange(w, dtype=torch.float64, device=dev),
                                    indexing="ij")
            cx = stride / 2.0 + xs * stride
            cy = stride / 2.0 + ys * stride
            size = torch.full_like(cx, 4.0 * stride)
            anchors = torch.stack([cx, cy, size, size], dim=-1).reshape(-1, 4) \
                .to(torch.float32)
        if torch.compiler.is_exporting():
            return anchors
        _anchor_cache[key] = anchors
    return _anchor_cache[key]


def detect_candidates(p: S3FD, images: torch.Tensor, score_thresh: float = 0.05,
                      subtract_mean: bool = True) -> torch.Tensor:
    """(B, H, W, 3) images (0-255) → (B, A, 5) [x1, y1, x2, y2, score] for
    every anchor, scores at or below ``score_thresh`` set to 0.
    ``subtract_mean`` subtracts the [104, 117, 123] mean in the images'
    dtype (pass BGR then, the face_alignment convention); the vendored
    preprocessing feeds raw RGB without it. Heads decode in float32."""
    x = images
    if subtract_mean:
        x = x - torch.tensor(MEAN_BGR_SUB, dtype=x.dtype, device=x.device)
    olist = s3fd_forward(p, x)
    b = x.shape[0]
    outs = []
    for i in range(6):
        cls_map = torch.softmax(olist[2 * i].float(), dim=-1)[..., 1]      # (B, h, w)
        loc_map = olist[2 * i + 1].float()                               # (B, h, w, 4)
        h, w = cls_map.shape[1], cls_map.shape[2]
        priors = dense_anchors(h, w, 2 ** (i + 2), x.device)
        boxes = decode_boxes(loc_map.reshape(b, -1, 4), priors[None])
        score = cls_map.reshape(b, -1)
        score = torch.where(score > score_thresh, score, torch.zeros_like(score))
        outs.append(torch.cat([boxes, score[..., None]], dim=-1))
    return torch.cat(outs, dim=1)


def nms_fixed(dets: torch.Tensor, iou_thresh: float = 0.3,
              top_k: int = 200) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over the ``top_k`` best-scored candidates of each image
    (replaces ``sfd/bbox.py:44-66``). dets (B, A, 5) or (A, 5). Returns
    (kept (…, top_k, 5) best first, keep mask (…, top_k)). Ties keep their
    anchor order (a stable sort, as ``jnp.argsort`` is)."""
    single = dets.dim() == 2
    if single:
        dets = dets[None]
    order = torch.sort(dets[..., 4], dim=-1, descending=True, stable=True).indices
    top = order[:, :top_k]
    d = torch.gather(dets, 1, top[..., None].expand(-1, -1, 5))     # (B, K, 5)
    x1, y1, x2, y2, s = d.unbind(-1)
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    xx1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    yy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    xx2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    yy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = torch.clamp_min(xx2 - xx1 + 1, 0.0) * torch.clamp_min(yy2 - yy1 + 1, 0.0)
    iou = inter / (areas[:, :, None] + areas[:, None, :] - inter)
    k = d.shape[1]
    earlier = torch.ones(k, k, dtype=torch.bool, device=d.device).tril(-1)
    suppressed_by = (iou > iou_thresh) & earlier                    # [i, j]: j < i
    keep = torch.zeros(d.shape[:2], dtype=torch.bool, device=d.device)
    for i in range(k):
        # i is dropped if a kept earlier candidate overlaps it
        sup = (suppressed_by[:, i] & keep).any(dim=-1)
        keep[:, i] = ~sup & (s[:, i] > 0)
    if single:
        return d[0], keep[0]
    return d, keep


def detect_faces(p: S3FD, images: torch.Tensor, score_thresh: float = 0.5,
                 iou_thresh: float = 0.3, top_k: int = 32,
                 subtract_mean: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched detection (``sfd/sfd_detector.py:31-45``): candidates →
    NMS(0.3) → score > 0.5. Returns (boxes (B, top_k, 5), valid (B, top_k)),
    best first."""
    cands = detect_candidates(p, images, subtract_mean=subtract_mean)
    kept, mask = nms_fixed(cands, iou_thresh, top_k)
    return kept, mask & (kept[..., 4] > score_thresh)
