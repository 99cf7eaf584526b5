"""The reference of the per-frame path: SFD → FAN → FFHQ crop, DECA
aligned by SFD + FAN on the crop, Δp → A, and the synthesis."""

from __future__ import annotations

from typing import Dict

import torch

from .model.geometry.directions import initialize_directions, make_shift_vector
from .model.models.deca.deca import calculate_shapemodel
from .model.models.direction_matrix import direction_matrix_forward
from .model.models.face.cropping import ffhq_crop_device
from .model.models.nn import adaptive_avg_pool2d
from .model.models.stylegan2 import mapping, mean_latent, style_to_wplus, synthesis
from .model.pipeline.preprocess import preprocess_batch_device
from .model.pipeline.reenactment import align_for, source_shape, to_u8


def spec_of(cfg: Dict):
    d = cfg["directions"]
    return initialize_directions(d["dataset"], d["learned_directions"], d["shift_scale"])


def truncation_latent(g, rng: torch.Generator) -> torch.Tensor:
    return mean_latent(g, rng, 4096)


def source(nets: Dict, z: torch.Tensor):
    """The source identity of a seeded z: its W+ code, and the coefficients
    and angles of its synthesized image."""
    code = style_to_wplus(nets["g"], [mapping(nets["g"], z)])
    params, angles = source_shape(nets["deca"], synthesis(nets["g"], code),
                                  nets["fan"], nets["sfd"])
    return code, params, angles


def preprocess(nets: Dict, frames: torch.Tensor, crop_size: int = 256):
    """Raw frames → (crops in [-1, 1], ok, in_frame, landmarks)."""
    return preprocess_batch_device(nets["sfd"], nets["fan"], frames, image_size=crop_size)


def crops_from(frames: torch.Tensor, landmarks: torch.Tensor, crop_size: int = 256):
    """The FFHQ crops that ``landmarks`` place on the raw frames, in [-1, 1]."""
    crops, _ = ffhq_crop_device(frames.float(), landmarks, image_size=crop_size)
    return crops / 127.5 - 1.0


def shift(nets: Dict, spec, src, crops_gan: torch.Tensor) -> torch.Tensor:
    """DECA on the crops (aligned by SFD + FAN) → Δp → A: (T, rows, 512)."""
    code, params_s, angles_s = src
    t = crops_gan.shape[0]
    params_t, angles_t = calculate_shapemodel(nets["deca"], crops_gan,
                                              align_fn=align_for(nets["fan"], nets["sfd"]))
    ps = {k: v.expand((t,) + tuple(v.shape[1:])) for k, v in params_s.items()}
    dp = make_shift_vector(spec, ps, params_t, angles_s.expand(t, 3), angles_t)
    return direction_matrix_forward(nets["a"], dp)


def latents(code: torch.Tensor, shift_code: torch.Tensor, trunc: torch.Tensor,
            truncation: float) -> torch.Tensor:
    """The shifted W+ code after truncation, as the synthesis takes it."""
    t = shift_code.shape[0]
    lat = code.expand((t,) + tuple(code.shape[1:])).clone()
    lat[:, :shift_code.shape[1]] += shift_code
    return trunc + truncation * (lat - trunc)


def images(g, lat: torch.Tensor) -> torch.Tensor:
    """The synthesis of W+ codes (after truncation), pooled to 256, as floats
    in [-1, 1]."""
    img = synthesis(g, lat)
    if img.shape[1] > 256:
        img = adaptive_avg_pool2d(img.permute(0, 3, 1, 2), (256, 256)).permute(0, 2, 3, 1)
    return img
