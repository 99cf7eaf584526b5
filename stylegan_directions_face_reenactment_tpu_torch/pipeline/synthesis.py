"""Latent-shift application and image generation (the reference's
``generic.py::get_shifted_latent_code`` / ``generate_image``).

Both take either generator kind, StyleGAN2 (``models/stylegan2.py``) or
StyleGAN3 (``models/stylegan3.py``), through one interface that each kind's
module defines: ``mapping``, ``mean_latent``, ``synthesis``,
``style_to_wplus``, ``generator_forward`` and the generator's
``n_latent``; :func:`generator_functions` picks the module."""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..models import stylegan2, stylegan3
from ..models.nn import adaptive_avg_pool2d

AnyGenerator = Union[stylegan2.Generator, "stylegan3.Generator"]


def generator_functions(g: AnyGenerator):
    """The module of ``g``'s kind: ``models.stylegan3`` for a StyleGAN3
    generator, ``models.stylegan2`` otherwise."""
    return stylegan3 if isinstance(g, stylegan3.Generator) else stylegan2


def get_shifted_latent_code(g: AnyGenerator, z: torch.Tensor, shift: torch.Tensor, *,
                            input_is_latent: bool = False, w_plus: bool = True,
                            num_layers: Optional[int] = None) -> torch.Tensor:
    """Add a direction shift to a latent code.

    z: (B, 512) z/w or (B, n_latent, 512) W+; shift: (B, num_layers, 512)
    when ``w_plus`` (added to the first rows) else (B, 512). Returns the
    shifted W+ code (B, n_latent, 512).
    """
    n_lat = g.n_latent
    if not input_is_latent:
        latent = generator_functions(g).mapping(g, z)[:, None, :].repeat(1, n_lat, 1)
    else:
        latent = z if z.dim() == 3 else z[:, None, :].repeat(1, n_lat, 1)
    latent = latent.clone()
    if not w_plus:
        rows = n_lat if num_layers is None else num_layers
        latent[:, :rows, :] += shift[:, None, :].to(latent.dtype)
    else:
        latent[:, :shift.shape[1], :] += shift.to(latent.dtype)
    return latent


def generate_image(g: AnyGenerator, latent_code: torch.Tensor, *,
                   truncation: float = 1.0,
                   truncation_latent: Optional[torch.Tensor] = None,
                   w_plus: bool = True, num_layers_shift: int = 8,
                   shift_code: Optional[torch.Tensor] = None,
                   input_is_latent: bool = False,
                   return_latents: bool = False,
                   compute_dtype: torch.dtype = torch.float32):
    """Synthesize, optionally shifting the code first (truncation then acts
    on the shifted code); NHWC outputs larger than 256 are pooled to 256."""
    generator_forward = generator_functions(g).generator_forward
    if shift_code is None:
        img, lat = generator_forward(
            g, [latent_code], truncation=truncation,
            truncation_latent=truncation_latent,
            input_is_latent=input_is_latent, return_latents=return_latents,
            compute_dtype=compute_dtype)
    else:
        shifted = get_shifted_latent_code(
            g, latent_code, shift_code, input_is_latent=input_is_latent,
            w_plus=w_plus, num_layers=num_layers_shift)
        img, lat = generator_forward(
            g, [shifted], truncation=truncation,
            truncation_latent=truncation_latent, input_is_latent=True,
            return_latents=return_latents, compute_dtype=compute_dtype)
    if img.shape[1] > 256:
        img = adaptive_avg_pool2d(img.permute(0, 3, 1, 2), (256, 256)).permute(0, 2, 3, 1)
    if return_latents:
        return img, lat
    return img
