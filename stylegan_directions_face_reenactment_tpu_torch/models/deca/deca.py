"""DECA, the encode side: ResNet-50 + MLP regressing the 236 coefficients.

Parameter split: 236 = shape 100 + tex 50 + exp 50 + pose 6 + cam 3 +
light 27. Public functions take NHWC images like the JAX package and return
its coefficient dicts; inside they compute in NCHW. FLAME decoding is not
on the serving path and is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ...geometry.rotations import batch_axis2euler, rad2deg
from ..nn import linear, relu, resize_bilinear
from .resnet import ResNet50, resnet50_features

PARAM_SPLIT = (("shape", 100), ("tex", 50), ("exp", 50), ("pose", 6),
               ("cam", 3), ("light", 27))
N_PARAM = sum(n for _, n in PARAM_SPLIT)  # 236
IMAGE_SIZE = 224


class ResnetEncoder(nn.Module):
    """ResNet-50 + MLP(2048 → 1024 → ReLU → outsize), named like the
    reference's ``encoders.ResnetEncoder`` (``encoder``, ``layers.0/2``)."""

    def __init__(self, outsize: int):
        super().__init__()
        self.encoder = ResNet50()
        self.layers = nn.Sequential(nn.Linear(2048, 1024), nn.ReLU(),
                                    nn.Linear(1024, outsize))


class DECA(nn.Module):
    """The coarse encoder ``E_flame``; the detail branch and FLAME come with
    the slices that need them."""

    def __init__(self):
        super().__init__()
        self.E_flame = ResnetEncoder(N_PARAM)


def resnet_encoder_forward(p: ResnetEncoder, images: torch.Tensor) -> torch.Tensor:
    """images (N, 3, H, W) → (N, outsize), in the images' dtype."""
    feats = resnet50_features(p.encoder, images)
    h = relu(linear(feats, p.layers[0].weight, p.layers[0].bias))
    return linear(h, p.layers[2].weight, p.layers[2].bias)


def decompose_code(code: torch.Tensor) -> Dict[str, torch.Tensor]:
    """236-vector → {shape, tex, exp, pose, cam, light}."""
    out, start = {}, 0
    for key, n in PARAM_SPLIT:
        out[key] = code[:, start:start + n]
        start += n
    out["light"] = out["light"].reshape(out["light"].shape[0], 9, 3)
    return out


def _encode_nchw(deca: DECA, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    return decompose_code(resnet_encoder_forward(deca.E_flame, images).float())


def _params_nchw(deca: DECA, images: torch.Tensor):
    codedict = _encode_nchw(deca, images)
    angles = rad2deg(batch_axis2euler(codedict["pose"][:, :3]))
    return (codedict["pose"], codedict["shape"], codedict["exp"], angles,
            codedict["cam"])


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2).contiguous()


def deca_encode(deca: DECA, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """images (B, 224, 224, 3) in [0, 1] → coefficient dict. The ResNet-50
    follows the images' dtype; the coefficients are always float32."""
    return _encode_nchw(deca, _nchw(images))


def extract_deca_params(deca: DECA, images224: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """Aligned (B, 224, 224, 3) RGB in [0, 1] → (pose (B, 6), shape (B, 100),
    exp (B, 50), angles in degrees (B, 3), cam (B, 3))."""
    return _params_nchw(deca, _nchw(images224))


def calculate_shapemodel(deca: DECA, images: torch.Tensor,
                         image_space: str = "gan", align_fn=None,
                         image_size: int = IMAGE_SIZE,
                         compute_dtype: Optional[torch.dtype] = None
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """GAN-range ([-1, 1]) or [0, 255] NHWC images → coefficient dict
    {pose, alpha_shp, alpha_exp, cam} + angles (B, 3) in degrees.

    DECA consumes [0, 1] at ``image_size``. ``align_fn`` maps the [0, 1]
    images to aligned 224 crops (``pipeline/alignment.py::make_fan_align``,
    the reference's FAN bbox → warp); when it also returns an ``ok`` mask,
    the frames it flags keep zero coefficients and −180° angles, the
    reference's failed-detection sentinel (``estimate_DECA.py:33-51``).
    Without it the images are resized bilinearly (``--deca_alignment
    resize``). ``compute_dtype`` runs the ResNet-50 trunk in that dtype;
    the coefficients come back float32.
    """
    if image_space == "gan":
        # the reference's torch_range_1_to_255 (with its /(2+1e-5)), then /255
        images = (torch.clamp(images, -1.0, 1.0) + 1.0) / 2.00001
    elif image_space == "255":
        images = images / 255.0
    ok = None
    if align_fn is not None:
        aligned = align_fn(images)
        if isinstance(aligned, tuple):
            aligned, ok = aligned
        x = _nchw(aligned)
    else:
        x = _nchw(images)
        if x.shape[2] != image_size or x.shape[3] != image_size:
            x = resize_bilinear(x, (image_size, image_size))
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    p, shp, exp, angles, cam = _params_nchw(deca, x)
    if ok is not None:
        m = ok[:, None]
        zero = torch.zeros((), dtype=torch.float32, device=m.device)
        p, shp, exp, cam = (torch.where(m, t, zero) for t in (p, shp, exp, cam))
        angles = torch.where(m, angles, torch.full_like(angles, -180.0))
    return {"pose": p, "alpha_shp": shp, "alpha_exp": exp, "cam": cam}, angles
