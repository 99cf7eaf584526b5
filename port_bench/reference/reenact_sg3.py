"""The reference of the StyleGAN3-T reenactment path: the source identity,
the truncation latent and the synthesis (a frame at a time) of
``model/models/stylegan3.py``; DECA, Δp and A are ``reenact.py``'s."""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import _disable_current_modes

from .model.models import stylegan3 as sg3
from .model.models.nn import adaptive_avg_pool2d
from .model.ops import filtered_lrelu
from .model.pipeline.reenactment import source_shape


def truncation_latent(g, rng: torch.Generator) -> torch.Tensor:
    return sg3.mean_latent(g, rng, 4096)


def source(nets: Dict, z: torch.Tensor):
    """The source identity of a seeded z: its W+ code, and the coefficients
    and angles of its synthesized image."""
    code = sg3.style_to_wplus(nets["g"], [sg3.mapping(nets["g"], z)])
    params, angles = source_shape(nets["deca"], sg3.synthesis(nets["g"], code),
                                  nets["fan"], nets["sfd"])
    return code, params, angles


def images(g, lat: torch.Tensor) -> torch.Tensor:
    """The synthesis of W+ codes (after truncation), pooled to 256, as floats
    in [-1, 1]."""
    img = sg3.synthesis(g, lat)
    if img.shape[1] > 256:
        img = adaptive_avg_pool2d(img.permute(0, 3, 1, 2), (256, 256)).permute(0, 2, 3, 1)
    return img


def count_flops(fn) -> float:
    """Matrix and convolution FLOPs of ``fn`` (``FlopCounterMode``), the
    filtered leaky ReLU's FIR convolutions left out: they are K4's work,
    read by ``k4_roofline``, and here they run zero-stuffed."""
    from torch.utils.flop_counter import FlopCounterMode
    filtered_lrelu.fir_context = _disable_current_modes
    try:
        with FlopCounterMode(display=False) as counter:
            fn()
    finally:
        filtered_lrelu.fir_context = filtered_lrelu.contextlib.nullcontext
    return float(counter.get_total_flops())
