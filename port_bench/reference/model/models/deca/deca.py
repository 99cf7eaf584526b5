"""DECA: the ResNet-50 + MLP encoder regressing the 236 coefficients, and
the FLAME decode of coefficients to projected landmarks and vertices.

Parameter split: 236 = shape 100 + tex 50 + exp 50 + pose 6 + cam 3 +
light 27. Public functions take NHWC images like the JAX package and return
its coefficient dicts; inside they compute in NCHW.

The detail branch (``E_detail``, a second encoder of 128 outputs, and
``D_detail``, the displacement decoder of ``decoders.py:19-56``) is built
only when asked (``DECA(..., with_detail=True)``); the renderer's
``decode_deca`` reads it. Every entry point of the reenactment, training and
serving paths builds DECA without it, as the JAX package's loader does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ...geometry.rotations import batch_axis2euler, batch_orth_proj, rad2deg
from ..nn import batch_norm, conv2d, leaky_relu, linear, relu, resize_bilinear
from .flame import FLAME, FLAMETex, flame_forward
from .resnet import ResNet50, resnet50_features

PARAM_SPLIT = (("shape", 100), ("tex", 50), ("exp", 50), ("pose", 6),
               ("cam", 3), ("light", 27))
N_PARAM = sum(n for _, n in PARAM_SPLIT)  # 236
N_DETAIL = 128
N_COND = 53                                # jaw pose 3 + expression 50
IMAGE_SIZE = 224
DETAIL_CHANNELS = ((128, 128), (128, 64), (64, 64), (64, 32), (32, 16))
DETAIL_OUT_SCALE = 0.01                    # the reference's max_z
DETAIL_BN_EPS = 0.8                        # ``BatchNorm2d(c, 0.8)``: eps, not momentum


class ResnetEncoder(nn.Module):
    """ResNet-50 + MLP(2048 → 1024 → ReLU → outsize), named like the
    reference's ``encoders.ResnetEncoder`` (``encoder``, ``layers.0/2``)."""

    def __init__(self, outsize: int):
        super().__init__()
        self.encoder = ResNet50()
        self.layers = nn.Sequential(nn.Linear(2048, 1024), nn.ReLU(),
                                    nn.Linear(1024, outsize))


class DetailGenerator(nn.Module):
    """The displacement decoder, laid out as the reference's
    ``decoders.Generator``: ``l1.0`` (latent → 128·8·8) and
    ``conv_blocks`` = [BatchNorm2d(128), then five times (Upsample ×2,
    Conv3x3, BatchNorm2d(c, eps 0.8), LeakyReLU 0.2), Conv3x3(16 → 1),
    Tanh], so its state dict is the checkpoint's ``D_detail``."""

    def __init__(self, latent_dim: int = N_DETAIL + N_COND, out_channels: int = 1):
        super().__init__()
        self.l1 = nn.Sequential(nn.Linear(latent_dim, 128 * 8 * 8))
        blocks = [nn.BatchNorm2d(128)]
        for cin, cout in DETAIL_CHANNELS:
            blocks += [nn.Upsample(scale_factor=2, mode="bilinear"),
                       nn.Conv2d(cin, cout, 3, padding=1),
                       nn.BatchNorm2d(cout, DETAIL_BN_EPS), nn.LeakyReLU(0.2)]
        blocks += [nn.Conv2d(16, out_channels, 3, padding=1), nn.Tanh()]
        self.conv_blocks = nn.Sequential(*blocks)


class DECA(nn.Module):
    """The coarse encoder ``E_flame``; with ``with_detail`` the detail
    encoder ``E_detail`` and decoder ``D_detail`` (else both None); and,
    when given, the :class:`FLAME` model ``flame`` and the texture space
    ``flametex``, whose arrays stay out of the state dict (the DECA
    checkpoint holds the three nets; FLAME and its texture come from their
    own files)."""

    def __init__(self, flame: Optional[FLAME] = None, with_detail: bool = False,
                 flametex: Optional[FLAMETex] = None):
        super().__init__()
        self.E_flame = ResnetEncoder(N_PARAM)
        self.E_detail = ResnetEncoder(N_DETAIL) if with_detail else None
        self.D_detail = DetailGenerator() if with_detail else None
        self.flame = flame
        self.flametex = flametex


def resnet_encoder_forward(p: ResnetEncoder, images: torch.Tensor) -> torch.Tensor:
    """images (N, 3, H, W) → (N, outsize), in the images' dtype."""
    feats = resnet50_features(p.encoder, images)
    h = relu(linear(feats, p.layers[0].weight, p.layers[0].bias))
    return linear(h, p.layers[2].weight, p.layers[2].bias)


def detail_generator_forward(p: DetailGenerator, noise: torch.Tensor) -> torch.Tensor:
    """noise (B, 181) = [jaw pose, expression, detail code] → displacement
    map (B, 256, 256, 1) NHWC, as the reference computes it: the linear
    layer's output viewed as (B, 128, 8, 8) (channel-major), batch norms at
    their running statistics (eps 1e-5 first, then 0.8), bilinear ×2
    upsamples without corner alignment, tanh · 0.01."""
    blocks = p.conv_blocks
    out = linear(noise, p.l1[0].weight, p.l1[0].bias).reshape(noise.shape[0], 128, 8, 8)
    out = batch_norm(out, blocks[0])
    for i in range(len(DETAIL_CHANNELS)):
        conv, bn = blocks[2 + 4 * i], blocks[3 + 4 * i]
        out = resize_bilinear(out, (out.shape[2] * 2, out.shape[3] * 2))
        out = conv2d(out, conv.weight, conv.bias, padding=1)
        out = leaky_relu(batch_norm(out, bn, eps=DETAIL_BN_EPS), 0.2)
    conv_out = blocks[1 + 4 * len(DETAIL_CHANNELS)]
    out = conv2d(out, conv_out.weight, conv_out.bias, padding=1)
    return (torch.tanh(out) * DETAIL_OUT_SCALE).permute(0, 2, 3, 1)


def decompose_code(code: torch.Tensor) -> Dict[str, torch.Tensor]:
    """236-vector → {shape, tex, exp, pose, cam, light}."""
    out, start = {}, 0
    for key, n in PARAM_SPLIT:
        out[key] = code[:, start:start + n]
        start += n
    out["light"] = out["light"].reshape(out["light"].shape[0], 9, 3)
    return out


def _encode_nchw(deca: DECA, images: torch.Tensor,
                 with_detail: bool = False) -> Dict[str, torch.Tensor]:
    codedict = decompose_code(resnet_encoder_forward(deca.E_flame, images).float())
    if with_detail and deca.E_detail is not None:
        codedict["detail"] = resnet_encoder_forward(deca.E_detail, images).float()
    return codedict


def _params_nchw(deca: DECA, images: torch.Tensor):
    codedict = _encode_nchw(deca, images)
    angles = rad2deg(batch_axis2euler(codedict["pose"][:, :3]))
    return (codedict["pose"], codedict["shape"], codedict["exp"], angles,
            codedict["cam"])


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2).contiguous()


def deca_encode(deca: DECA, images: torch.Tensor,
                with_detail: bool = False) -> Dict[str, torch.Tensor]:
    """images (B, 224, 224, 3) in [0, 1] → coefficient dict, with the
    detail code ``detail`` (B, 128) when asked and the model has
    ``E_detail``. The ResNet-50s follow the images' dtype; the coefficients
    are always float32."""
    return _encode_nchw(deca, _nchw(images), with_detail)


def extract_deca_params(deca: DECA, images224: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """Aligned (B, 224, 224, 3) RGB in [0, 1] → (pose (B, 6), shape (B, 100),
    exp (B, 50), angles in degrees (B, 3), cam (B, 3))."""
    return _params_nchw(deca, _nchw(images224))


def _project(points: torch.Tensor, cam: torch.Tensor, half: float) -> torch.Tensor:
    """Weak-perspective projection, y and z flipped, into the image frame."""
    p = batch_orth_proj(points, cam)
    p = torch.cat([p[:, :, :1], -p[:, :, 1:]], dim=2)
    return p * half + half


def deca_decode(deca: DECA, codedict: Dict[str, torch.Tensor], image_size: int = IMAGE_SIZE
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Coefficients {shape, exp, pose, cam} → (landmarks2d (B, 68, 2),
    landmarks3d (B, 68, 3), trans_verts (B, V, 3)) in the ``image_size``
    frame (``deca.py:229-239``)."""
    if deca.flame is None:
        raise ValueError("deca_decode needs a DECA built with its FLAME model")
    verts, landmarks2d, landmarks3d = flame_forward(
        deca.flame, codedict["shape"], codedict["exp"], codedict["pose"])
    half = image_size / 2.0
    cam = codedict["cam"]
    return (_project(landmarks2d, cam, half)[:, :, :2], _project(landmarks3d, cam, half),
            _project(verts, cam, half))


def calculate_shape(deca: DECA, coefficients: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(landmarks2d, landmarks3d, trans_verts) from a coefficient dict with
    keys {shape, exp, pose, cam} (``estimate_DECA.py:55-57``)."""
    return deca_decode(deca, coefficients)


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
