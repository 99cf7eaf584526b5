"""Source set-up: crop → e4e inversion → (PTI) → DECA coefficients.

PyTorch counterpart of ``stylegan_directions_face_reenactment_tpu/pipeline/
source_setup.py`` (the reference's ``load_source_data``,
``run_inference.py:103-127``), run once per identity before any frame is
served: its outputs are the source W+ code, the tuned generator and the
source coefficients that the per-frame paths take.

The FFHQ crop is always 256, whatever the generator's size: the reference's
``crop_using_landmarks`` hard-codes it (``ffhq_cropping.py:50-65``), and
e4e, ArcFace and DECA all take that crop. :func:`make_prep_fn` is the
CLI's preparation of frames into such crops (a host resize of ready crops,
or SFD → FAN → FFHQ crop); :func:`setup_source` takes any ``prep``
callable.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..losses.lpips import LPIPS
from ..models.deca.deca import DECA
from ..models.e4e import Encoder4Editing
from ..models.face.fan import FAN
from ..models.face.s3fd import S3FD
from ..models.stylegan2 import Generator
from ..native.imgproc import resize_bilinear_u8
from ..utils.device import DeviceLike, resolve_device
from .inversion import invert_image
from .preprocess import DETECT_WIDTH, preprocess_images
from .pti import optimize_g
from .reenactment import source_shape

CROP_SIZE = 256  # `ffhq_cropping.py:50`, independent of G's size


def pad_batch(x: np.ndarray, pad: int) -> np.ndarray:
    """Pad a frame chunk to a fixed batch by repeating the last row (callers
    slice the outputs back to the true length)."""
    return np.concatenate([x] + [x[-1:]] * pad) if pad else x


def make_prep_fn(s3fd_params: Optional[S3FD], fan_params: Optional[FAN], *,
                 skip_preprocess: bool = False, device_crop: bool = True,
                 crop_size: int = CROP_SIZE, return_landmarks: bool = False,
                 detect_width: Optional[int] = None,
                 device: DeviceLike = None) -> Callable:
    """``prep(frames)``: HWC uint8 frames → ((B, crop, crop, 3) float32 in
    [-1, 1], ok (B,)[, landmarks in crop coordinates (B, 68, 2) with
    ``return_landmarks``]).

    ``skip_preprocess``: the frames are FFHQ crops already, resized
    bilinearly on the host (the CLIs' ``--skip_preprocess``); otherwise
    :func:`preprocess_images` (SFD → FAN → FFHQ crop on ``device``) after a
    rescale to ``detect_width`` (None: the reference's 1000; 0: none)."""
    if return_landmarks and skip_preprocess:
        raise ValueError("return_landmarks requires the detection prep "
                         "(incompatible with skip_preprocess)")

    def prep(frames: List[np.ndarray]) -> Tuple[np.ndarray, ...]:
        if skip_preprocess:
            batch = resize_bilinear_u8(np.stack(frames).astype(np.uint8), (crop_size, crop_size))
            return batch.astype(np.float32) / 127.5 - 1.0, np.ones(len(frames), bool)
        return preprocess_images(s3fd_params, fan_params, frames, image_size=crop_size,
                                 device_crop=device_crop, return_landmarks=return_landmarks,
                                 detect_width=DETECT_WIDTH if detect_width is None
                                 else detect_width, device=device)

    return prep


def setup_source(g_params: Generator, e4e_params: Encoder4Editing, deca_params: DECA,
                 src_frames: List[np.ndarray], prep: Callable, *,
                 truncation_latent, optimize_generator: bool = True,
                 lpips_params: Optional[LPIPS] = None,
                 fan_params: Optional[FAN] = None,
                 s3fd_params: Optional[S3FD] = None,
                 opt_steps: int = 200, lr: float = 3e-3, truncation: float = 0.7,
                 device: DeviceLike = None):
    """Crop the source with ``prep`` (frames → (batch (B, 256, 256, 3) in
    [-1, 1], ok mask, ...)), e4e-invert the first crop, optionally
    PTI-tune a copy of the generator on it, and read its DECA coefficients,
    aligned as ``source_shape`` says for ``fan_params`` / ``s3fd_params``.

    Runs on ``device`` (the CUDA card by default; it raises when there is
    none), where the modules are moved. The inversion and the coefficients
    run under ``torch.no_grad()``, PTI with gradients on. Returns
    (source_img (1, 256, 256, 3), source_code (1, n_latent, 512) W+,
    g_source, params_source, angles_source).
    """
    if optimize_generator and lpips_params is None:
        raise ValueError("optimize_generator requires lpips_params")
    dev = resolve_device(device)
    for m in (g_params, e4e_params, deca_params, lpips_params, fan_params, s3fd_params):
        if m is not None:
            m.to(dev).eval()
    trunc = torch.as_tensor(truncation_latent, dtype=torch.float32).to(dev)

    res = prep(src_frames)
    src_batch, ok = res[0], res[1]   # prep may also return landmarks
    if not bool(ok[0]):
        raise RuntimeError("no face detected in the source image")
    source_img = torch.as_tensor(src_batch[:1], dtype=torch.float32).to(dev)
    with torch.no_grad():
        # the reconstruction is not used: the code alone
        _, source_code = invert_image(source_img, e4e_params, g_params,
                                      truncation=truncation, truncation_latent=trunc,
                                      resynthesize=False)
    if optimize_generator:
        g_source, _ = optimize_g(g_params, source_code, source_img, lpips_params, trunc,
                                 opt_steps=opt_steps, lr=lr, truncation=truncation)
    else:
        g_source = g_params
    with torch.no_grad():
        params_source, angles_source = source_shape(deca_params, source_img,
                                                    fan_params=fan_params,
                                                    s3fd_params=s3fd_params)
    return source_img, source_code, g_source, params_source, angles_source
