"""Image inversion with e4e (the reference's
``utils_inference.py:85-102``; the JAX package's ``pipeline/inversion.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.e4e import Encoder4Editing, e4e_forward
from ..models.stylegan2 import Generator
from ..utils.device import DeviceLike, resolve_device
from .synthesis import generate_image


def invert_image(images: torch.Tensor, e4e_params: Encoder4Editing,
                 g_params: Generator, truncation: float = 0.7,
                 truncation_latent: Optional[torch.Tensor] = None,
                 resynthesize: bool = True
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """images (B, 256, 256, 3) in [-1, 1] → (reconstruction or None, W+
    codes (B, n_latent, 512)): the encoder, then with ``resynthesize``
    G([codes], input_is_latent=True) at ``truncation``."""
    codes = e4e_forward(e4e_params, images)
    if not resynthesize:
        return None, codes
    inv = generate_image(g_params, codes, truncation=truncation,
                         truncation_latent=truncation_latent, input_is_latent=True)
    return inv, codes


def make_invert_fn(e4e_params: Encoder4Editing, g_params: Generator,
                   truncation: float = 0.7,
                   truncation_latent: Optional[torch.Tensor] = None,
                   resynthesize: bool = True, device: DeviceLike = None):
    """Batch inverter ``fn(images) → (reconstruction, W+ codes)`` running
    under ``torch.no_grad()`` on ``device`` (the CUDA card by default; it
    raises when there is none). The modules are moved there; images may be
    a numpy array or a tensor. No-grad rather than inference mode, so the
    codes can feed PTI's backward."""
    dev = resolve_device(device)
    e4e_params.to(dev).eval()
    g_params.to(dev).eval()
    trunc = None if truncation_latent is None else torch.as_tensor(truncation_latent).to(dev)

    def fn(images):
        with torch.no_grad():
            return invert_image(torch.as_tensor(images, dtype=torch.float32, device=dev),
                                e4e_params, g_params, truncation=truncation,
                                truncation_latent=trunc, resynthesize=resynthesize)

    return fn
