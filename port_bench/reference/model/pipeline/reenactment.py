"""Face reenactment: the per-frame program, batched over target frames.

Counterpart of the JAX package's ``pipeline/reenactment.py`` (the
reference's ``run_inference.py:157-254``): DECA on the target frames → Δp
→ A → synthesis of the shifted W+ code, onto one source identity. The DECA
alignment is the faithful SFD → FAN chain (``fan_params`` and
``s3fd_params``), FAN on the whole frame ("fan_frame", ``fan_params``
alone), landmarks from the preprocessing pass (``target_lms``), or a plain
resize (none of them). :func:`reenact_raw_batch` adds the preprocessing
(SFD → FAN → FFHQ crop) in front, raw frames in, reenacted faces out.

``fan_params`` / ``s3fd_params`` / ``sfd_prep`` / ``fan_prep`` are the
port's :class:`FAN` / :class:`S3FD` modules (the JAX package's parameter
pytrees under the same names). ``mesh=`` (``parallel/mesh.py``) is frame
data parallelism in one process: the frozen nets are copied once to each
of the mesh's devices, every frame batch is split over them on axis 0
(it must divide the mesh), the parts run one after another with no
synchronize between them, and the outputs are gathered in frame order on
the mesh's first device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..geometry.directions import DirectionsSpec, make_shift_vector
from ..models.deca.deca import DECA, calculate_shapemodel
from ..models.direction_matrix import DirectionMatrix, direction_matrix_forward
from ..models.face.cropping import landmarks_in_crop
from ..models.face.fan import FAN
from ..models.face.s3fd import S3FD
from ..models.stylegan2 import Generator
from .alignment import landmark_align, make_fan_align
from .preprocess import preprocess_batch_device
from .synthesis import generate_image

OUTPUTS = ("full", "reenact")


def align_for(fan_params: Optional[FAN], s3fd_params: Optional[S3FD] = None,
              compute_dtype: Optional[torch.dtype] = None):
    """The DECA aligner for these nets, returning the ``ok`` mask so that
    ``calculate_shapemodel`` applies the failed-detection sentinel; None
    (the resize) without ``fan_params``. Only the SFD path can fail."""
    if fan_params is None:
        return None
    return make_fan_align(fan_params, s3fd=s3fd_params, compute_dtype=compute_dtype,
                          return_ok=True)


def source_shape(deca: DECA, source_img: torch.Tensor,
                 fan_params: Optional[FAN] = None,
                 s3fd_params: Optional[S3FD] = None):
    """DECA coefficients and angles of the (1, 256, 256, 3) source image in
    [-1, 1], aligned as ``align_for`` says."""
    return calculate_shapemodel(deca, source_img,
                                align_fn=align_for(fan_params, s3fd_params))


def reenact_batch(g: Generator, a: DirectionMatrix, deca: DECA,
                  spec: DirectionsSpec, source_code: torch.Tensor,
                  params_source: Dict[str, torch.Tensor],
                  angles_source: torch.Tensor,
                  target_imgs: torch.Tensor, *,
                  truncation: float = 0.7,
                  truncation_latent: Optional[torch.Tensor] = None,
                  num_layers_shift: int = 8,
                  compute_dtype: torch.dtype = torch.float32,
                  fan_params: Optional[FAN] = None,
                  s3fd_params: Optional[S3FD] = None,
                  return_target_params: bool = False,
                  target_lms: Optional[torch.Tensor] = None,
                  target_ok: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Reenact a batch of target frames onto one source identity.

    source_code: (1, n_latent, 512) W+ of the source; params_source /
    angles_source: DECA outputs for the source (batch 1); target_imgs:
    (T, 256, 256, 3) in [-1, 1]; target_lms / target_ok: (T, 68, 2)
    landmarks in target-image coordinates and their (T,) mask, used for the
    DECA alignment instead of a second SFD + FAN pass.

    Returns (reenacted (T, 256, 256, 3), shifted latents (T, n_latent, 512));
    with ``return_target_params`` also (params_target, angles_target).
    ``compute_dtype`` bf16 runs SFD, FAN, the DECA trunk and the synthesis
    in bf16; boxes, heatmap peaks, coefficients and Δp stay float32.
    """
    t = target_imgs.shape[0]
    align_dtype = None if compute_dtype == torch.float32 else compute_dtype
    if target_lms is not None:
        def align_fn(imgs01):
            return landmark_align(imgs01, target_lms, target_ok)
    else:
        align_fn = align_for(fan_params, s3fd_params, compute_dtype=align_dtype)
    params_target, angles_target = calculate_shapemodel(
        deca, target_imgs, align_fn=align_fn, compute_dtype=align_dtype)

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


def to_u8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images → uint8 with round half up (the device crop's
    quantization; the host float path truncates, at most 1 unit apart)."""
    return torch.floor(torch.clamp((images + 1.0) * 127.5, 0.0, 255.0) + 0.5).to(torch.uint8)


def reenact_raw_batch(g: Generator, a: DirectionMatrix, deca: DECA,
                      spec: DirectionsSpec, sfd_prep: S3FD, fan_prep: FAN,
                      source_code: torch.Tensor,
                      params_source: Dict[str, torch.Tensor],
                      angles_source: torch.Tensor,
                      raw_frames: torch.Tensor, *,
                      crop_size: int = 256,
                      truncation: float = 0.7,
                      truncation_latent: Optional[torch.Tensor] = None,
                      num_layers_shift: int = 8,
                      compute_dtype: torch.dtype = torch.float32,
                      fan_params: Optional[FAN] = None,
                      s3fd_params: Optional[S3FD] = None,
                      reuse_landmarks: bool = False,
                      output_u8: bool = False,
                      outputs: str = "full"):
    """The whole per-frame path: raw frames in, reenacted faces out.

    Preprocessing (SFD on the raw frame → FAN → FFHQ crop,
    ``utils_inference.py:61-82``) then :func:`reenact_batch` on the crops.
    raw_frames: (T, H, W, 3) uint8 or float RGB at the detection
    resolution. With ``reuse_landmarks`` the preprocessing landmarks, mapped
    into the crop, feed the DECA alignment instead of a second SFD + FAN.

    ``outputs``:
      * "full": (reenacted (T, s, s, 3), latents, crops_u8 (T, crop, crop,
        3), ok (T,), in_frame (T,), landmarks (T, 68, 2));
      * "reenact": (reenacted uint8, ok, in_frame, landmarks).
    ``in_frame`` is False where the FFHQ box leaves the frame: those crops
    are edge-clamped approximations of the host crop. ``output_u8`` returns
    the reenacted images as uint8.
    """
    if outputs not in OUTPUTS:
        raise ValueError(f"outputs must be one of {OUTPUTS}, got {outputs!r}")
    align_dtype = None if compute_dtype == torch.float32 else compute_dtype
    crops_gan, ok, in_frame, pts = preprocess_batch_device(
        sfd_prep, fan_prep, raw_frames, image_size=crop_size, compute_dtype=align_dtype)
    kw = dict(truncation=truncation, truncation_latent=truncation_latent,
              num_layers_shift=num_layers_shift, compute_dtype=compute_dtype)
    if reuse_landmarks:
        lms_crop, _ = landmarks_in_crop(pts, image_size=crop_size)
        reenacted, latents = reenact_batch(
            g, a, deca, spec, source_code, params_source, angles_source, crops_gan,
            target_lms=lms_crop, target_ok=ok, **kw)
    else:
        reenacted, latents = reenact_batch(
            g, a, deca, spec, source_code, params_source, angles_source, crops_gan,
            fan_params=fan_params, s3fd_params=s3fd_params, **kw)
    crops_u8 = to_u8(crops_gan)          # the integer-valued crops, exactly
    if output_u8 or outputs == "reenact":
        reenacted = to_u8(reenacted)
    if outputs == "reenact":
        return reenacted, ok, in_frame, pts
    return reenacted, latents, crops_u8, ok, in_frame, pts
