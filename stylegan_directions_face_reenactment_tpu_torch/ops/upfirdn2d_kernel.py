"""K1: the hand-written CUDA kernel for upfirdn2d with up in {1, 2}, down 1.

Replaces the Pallas TPU kernel ``stylegan_directions_face_reenactment_tpu/
ops/pallas_upfirdn.py::_forward`` (entered there through
``upfirdn2d_pallas``, ``blur_pallas`` and ``upsample2d_pallas``). On the
serving path it runs 12 times a request: the blur after each of the six
upsampling StyledConvs and each of the six ToRGB skip upsamples.

Bound on an H100: device-memory bytes (one read of the input, one write of
the output); at most 16 FMAs an output are nothing beside them. The source
(``csrc/upfirdn2d.cu``) says what its design does about that.

* :func:`upfirdn2d_plain` is the plain PyTorch version of the same function
  (``ops/upfirdn2d.py::upfirdn2d``); :func:`upfirdn2d_fir` takes it only for
  CPU tensors.
* :func:`upfirdn2d_cuda` launches the kernel and counts its launches in
  ``upfirdn2d_cuda.launches``.
* The kernel is forward only; its backward (the down = 2 upfirdn2d of the
  cotangent) comes with the PTI/training slice.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .kernel_build import check, load_library
from .upfirdn2d import normalize_pad, upfirdn2d as upfirdn2d_plain, upfirdn2d_output_shape

MAX_TAPS = 4
_ENTRY = {torch.float32: "upfirdn2d_f32", torch.bfloat16: "upfirdn2d_bf16"}


def _flipped_taps(kernel) -> Tuple[int, int, ctypes.Array]:
    k = np.asarray(torch.as_tensor(kernel, dtype=torch.float32).cpu())
    if k.ndim != 2 or k.shape[0] > MAX_TAPS or k.shape[1] > MAX_TAPS:
        raise ValueError(f"upfirdn2d kernel takes at most {MAX_TAPS}x{MAX_TAPS} "
                         f"taps, got {k.shape}")
    taps = np.zeros((MAX_TAPS, MAX_TAPS), np.float32)
    taps[:k.shape[0], :k.shape[1]] = k[::-1, ::-1]
    return k.shape[0], k.shape[1], (ctypes.c_float * taps.size)(*taps.ravel().tolist())


def upfirdn2d_cuda(x: torch.Tensor, kernel, up: int,
                   pad: Tuple[int, ...]) -> torch.Tensor:
    """Launch K1 on a contiguous NCHW CUDA tensor (f32 or bf16)."""
    if not x.is_cuda:
        raise ValueError("upfirdn2d_cuda takes a CUDA tensor")
    if x.dtype not in _ENTRY:
        raise TypeError(f"upfirdn2d_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("upfirdn2d_cuda takes a contiguous NCHW tensor")
    if up not in (1, 2):
        raise ValueError(f"upfirdn2d_cuda takes up in {{1, 2}}, got {up}")
    kh, kw, taps = _flipped_taps(kernel)
    px0, px1, py0, py1 = normalize_pad(pad)
    n, c, h, w = x.shape
    out_h, out_w = upfirdn2d_output_shape(h, w, (kh, kw), up=up, pad=pad)
    if out_h < 1 or out_w < 1:
        raise ValueError(f"upfirdn2d_cuda: empty output {out_h}x{out_w}")
    y = torch.empty((n, c, out_h, out_w), dtype=x.dtype, device=x.device)
    fn = getattr(load_library(), _ENTRY[x.dtype])
    status = fn(x.data_ptr(), y.data_ptr(), n * c, h, w, out_h, out_w, up,
                px0, py0, kh, kw, taps,
                torch.cuda.current_stream(x.device).cuda_stream)
    check(status, "upfirdn2d_cuda")
    upfirdn2d_cuda.launches += 1
    return y


upfirdn2d_cuda.launches = 0


class _Upfirdn2dCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, up, pad):
        return upfirdn2d_cuda(x, kernel, up, pad)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the upfirdn2d CUDA kernel is forward only; its backward (down = 2 "
            "upfirdn2d of the cotangent) comes with the PTI/training slice")


def upfirdn2d_fir(x: torch.Tensor, kernel, up: int,
                  pad: Tuple[int, ...]) -> torch.Tensor:
    """upfirdn2d with up in {1, 2}, down 1: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.is_cuda:
        return _Upfirdn2dCUDA.apply(x, kernel, up, pad)
    if x.device.type != "cpu":
        raise ValueError(f"upfirdn2d runs on cuda or cpu, not {x.device}")
    return upfirdn2d_plain(x, kernel, up=up, down=1, pad=pad)
