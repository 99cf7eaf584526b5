"""Face reenactment: the per-frame program, batched over target frames.

DECA (resize alignment) → Δp → A → synthesis of the shifted W+ code, for a
batch of target frames onto one source identity. The faithful SFD → FAN
alignment and the reused-landmark mode come with the SFD/FAN alignment
slice; asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..geometry.directions import DirectionsSpec, make_shift_vector
from ..models.deca.deca import DECA, calculate_shapemodel
from ..models.direction_matrix import DirectionMatrix, direction_matrix_forward
from ..models.stylegan2 import Generator
from ..utils.device import DeviceLike, resolve_device
from .synthesis import generate_image

_LATER = "comes with the SFD/FAN alignment slice of the port"


def _refuse_alignment(fan_params=None, s3fd_params=None, target_lms=None) -> None:
    if fan_params is not None or s3fd_params is not None:
        raise NotImplementedError(f"FAN/SFD DECA alignment {_LATER}")
    if target_lms is not None:
        raise NotImplementedError(f"alignment from reused landmarks {_LATER}")


def reenact_batch(g: Generator, a: DirectionMatrix, deca: DECA,
                  spec: DirectionsSpec, source_code: torch.Tensor,
                  params_source: Dict[str, torch.Tensor],
                  angles_source: torch.Tensor,
                  target_imgs: torch.Tensor, *,
                  truncation: float = 0.7,
                  truncation_latent: Optional[torch.Tensor] = None,
                  num_layers_shift: int = 8,
                  compute_dtype: torch.dtype = torch.float32,
                  fan_params=None, s3fd_params=None,
                  return_target_params: bool = False,
                  target_lms=None) -> Tuple[torch.Tensor, ...]:
    """Reenact a batch of target frames onto one source identity.

    source_code: (1, n_latent, 512) W+ of the source; params_source /
    angles_source: DECA outputs for the source (batch 1); target_imgs:
    (T, 256, 256, 3) in [-1, 1].

    Returns (reenacted (T, 256, 256, 3), shifted latents (T, n_latent, 512));
    with ``return_target_params`` also (params_target, angles_target).
    ``compute_dtype`` bf16 runs the synthesis and the DECA ResNet-50 trunk in
    bf16; the coefficients and Δp stay float32.
    """
    _refuse_alignment(fan_params, s3fd_params, target_lms)
    t = target_imgs.shape[0]
    align_dtype = None if compute_dtype == torch.float32 else compute_dtype
    params_target, angles_target = calculate_shapemodel(
        deca, target_imgs, compute_dtype=align_dtype)

    ps = {k: v.expand((t,) + tuple(v.shape[1:])) for k, v in params_source.items()}
    angs = angles_source.expand(t, 3)
    delta_p = make_shift_vector(spec, ps, params_target, angs, angles_target)
    shift = direction_matrix_forward(a, delta_p)                 # (T, L, 512)

    codes = source_code.expand((t,) + tuple(source_code.shape[1:]))
    reenacted, shifted_latents = generate_image(
        g, codes, truncation=truncation, truncation_latent=truncation_latent,
        w_plus=True, num_layers_shift=num_layers_shift, shift_code=shift,
        input_is_latent=True, return_latents=True, compute_dtype=compute_dtype)
    if return_target_params:
        return reenacted, shifted_latents, params_target, angles_target
    return reenacted, shifted_latents


def make_reenact_fn(g: Generator, a: DirectionMatrix, deca: DECA,
                    spec: DirectionsSpec, *, truncation: float = 0.7,
                    truncation_latent: Optional[torch.Tensor] = None,
                    num_layers_shift: int = 8,
                    compute_dtype: torch.dtype = torch.float32,
                    fan_params=None, s3fd_params=None, mesh=None,
                    return_target_params: bool = False,
                    reuse_landmarks: bool = False,
                    device: DeviceLike = None):
    """Reenactor ``fn(source_code, params_source, angles_source,
    target_imgs) → (reenacted, latents)`` running under
    ``torch.inference_mode()`` on ``device`` (the CUDA card by default; it
    raises when there is none). The modules are moved onto ``device``;
    inputs may be numpy arrays or tensors, and outputs are tensors there.
    """
    _refuse_alignment(fan_params, s3fd_params)
    if reuse_landmarks:
        raise NotImplementedError(f"reuse_landmarks {_LATER}")
    if mesh is not None:
        raise NotImplementedError("frame data parallelism over several cards "
                                  "is not ported yet")
    dev = resolve_device(device)
    for m in (g, a, deca):
        m.to(dev).eval()
    trunc = None if truncation_latent is None else truncation_latent.to(dev)

    def to_dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    def fn(source_code, params_source, angles_source, target_imgs):
        with torch.inference_mode():
            return reenact_batch(
                g, a, deca, spec, to_dev(source_code),
                {k: to_dev(v) for k, v in params_source.items()},
                to_dev(angles_source), to_dev(target_imgs),
                truncation=truncation, truncation_latent=trunc,
                num_layers_shift=num_layers_shift, compute_dtype=compute_dtype,
                return_target_params=return_target_params)

    return fn
