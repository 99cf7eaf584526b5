"""K1: the hand-written CUDA kernel for upfirdn2d with (up, down) in
{(1, 1), (2, 1), (1, 2)}, and the autograd Function that runs it both ways.

Replaces the Pallas TPU kernel ``stylegan_directions_face_reenactment_tpu/
ops/pallas_upfirdn.py::_forward`` (entered there through
``upfirdn2d_pallas``, ``blur_pallas`` and ``upsample2d_pallas``) and that
file's ``_backward``, the gradient identity that the JAX package runs as an
XLA upfirdn2d (no Pallas call of its own): the cotangent through the flipped
taps with up and down swapped and the pads of :func:`grad_pad`. On the
serving path the forward runs 12 times a request: the blur after each of the
six upsampling StyledConvs and each of the six ToRGB skip upsamples. A PTI
step of source set-up adds the backward of the blurs and skip upsamples that
lie downstream of the tuned ``convs[4..11]`` (``ops/main_path.py``): the
blur's backward is up 1, down 1, pad (2, 2); the skip upsample's is up 1,
down 2, pad (1, 1).

Bound on an H100: device-memory bytes (one read of the input, one write of
the output); at most 16 FMAs an output are nothing beside them. The source
(``csrc/upfirdn2d.cu``) says what its design does about that.

* :func:`upfirdn2d_plain` is the plain PyTorch version of the same function
  (``ops/upfirdn2d.py::upfirdn2d``), and :func:`upfirdn2d_backward` the
  plain version of the backward; :func:`upfirdn2d_fir` takes the plain
  version only for CPU tensors, where autograd differentiates it.
* :func:`upfirdn2d_cuda` launches the forward and counts its launches in
  ``upfirdn2d_cuda.launches``; :func:`upfirdn2d_bwd_cuda` launches the
  backward and counts in ``upfirdn2d_bwd_cuda.launches``, of which
  ``upfirdn2d_bwd_cuda.down2_launches`` ran with down = 2.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .kernel_build import check, load_library
from .upfirdn2d import normalize_pad, upfirdn2d as upfirdn2d_plain, upfirdn2d_output_shape

MAX_TAPS = 4
_UPDOWN = ((1, 1), (2, 1), (1, 2))
_ENTRY = {torch.float32: "upfirdn2d_f32", torch.bfloat16: "upfirdn2d_bf16"}


def _taps(kernel) -> np.ndarray:
    return np.asarray(torch.as_tensor(kernel, dtype=torch.float32).cpu())


def _flipped_taps(k: np.ndarray) -> Tuple[int, int, ctypes.Array]:
    if k.ndim != 2 or k.shape[0] > MAX_TAPS or k.shape[1] > MAX_TAPS:
        raise ValueError(f"upfirdn2d kernel takes at most {MAX_TAPS}x{MAX_TAPS} "
                         f"taps, got {k.shape}")
    taps = np.zeros((MAX_TAPS, MAX_TAPS), np.float32)
    taps[:k.shape[0], :k.shape[1]] = k[::-1, ::-1]
    return k.shape[0], k.shape[1], (ctypes.c_float * taps.size)(*taps.ravel().tolist())


def grad_pad(kernel_shape: Tuple[int, int], up: int, pad,
             in_hw: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """The pads (px0, px1, py0, py1) of the gradient of an up-``up``, down-1
    upfirdn2d with ``pad`` over an input of ``in_hw``: per axis
    ``(k - p0 - 1, in·up - out + p0 - up + 1)`` (the reference's
    ``op/upfirdn2d.py:104-117``, as the JAX package's ``_backward``),
    computed per axis since ``pad`` may differ between them."""
    kh, kw = kernel_shape
    px0, px1, py0, py1 = normalize_pad(pad)
    h, w = in_hw
    oh, ow = upfirdn2d_output_shape(h, w, (kh, kw), up=up, pad=pad)
    return (kw - px0 - 1, w * up - ow + px0 - up + 1,
            kh - py0 - 1, h * up - oh + py0 - up + 1)


def upfirdn2d_backward(grad: torch.Tensor, kernel, up: int, pad,
                       in_shape: Sequence[int]) -> torch.Tensor:
    """Plain version of the backward: the gradient with respect to the input
    (of NCHW shape ``in_shape``) of ``upfirdn2d(x, kernel, up, down=1, pad)``
    from the output's gradient ``grad``: an upfirdn2d of ``grad`` with the
    flipped taps, up 1, down ``up``, and the pads of :func:`grad_pad`."""
    k = torch.as_tensor(kernel, dtype=torch.float32)
    gpad = grad_pad(tuple(k.shape), up, pad, tuple(in_shape[2:]))
    return upfirdn2d_plain(grad, torch.flip(k, (0, 1)), up=1, down=up, pad=gpad)


def _launch(x: torch.Tensor, k: np.ndarray, up: int, down: int,
            pad: Tuple[int, ...], what: str) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"{what} takes a CUDA tensor")
    if x.dtype not in _ENTRY:
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous NCHW tensor")
    if (up, down) not in _UPDOWN:
        raise ValueError(f"{what} takes (up, down) in {_UPDOWN}, got {(up, down)}")
    kh, kw, taps = _flipped_taps(k)
    px0, px1, py0, py1 = normalize_pad(pad)
    n, c, h, w = x.shape
    out_h, out_w = upfirdn2d_output_shape(h, w, (kh, kw), up=up, down=down, pad=pad)
    if out_h < 1 or out_w < 1:
        raise ValueError(f"{what}: empty output {out_h}x{out_w}")
    y = torch.empty((n, c, out_h, out_w), dtype=x.dtype, device=x.device)
    fn = getattr(load_library(), _ENTRY[x.dtype])
    status = fn(x.data_ptr(), y.data_ptr(), n * c, h, w, out_h, out_w, up, down,
                px0, py0, kh, kw, taps,
                torch.cuda.current_stream(x.device).cuda_stream)
    check(status, what)
    return y


def upfirdn2d_cuda(x: torch.Tensor, kernel, up: int,
                   pad: Tuple[int, ...]) -> torch.Tensor:
    """Launch K1 (down 1) on a contiguous NCHW CUDA tensor (f32 or bf16)."""
    y = _launch(x, _taps(kernel), up, 1, pad, "upfirdn2d_cuda")
    upfirdn2d_cuda.launches += 1
    return y


upfirdn2d_cuda.launches = 0


def upfirdn2d_bwd_cuda(grad: torch.Tensor, kernel, up: int, pad,
                       in_shape: Sequence[int]) -> torch.Tensor:
    """Launch K1 on the backward of ``upfirdn2d_cuda(x, kernel, up, pad)``:
    the gradient with respect to x (NCHW ``in_shape``) from ``grad``, a
    contiguous CUDA tensor (f32 or bf16). :func:`upfirdn2d_backward` is its
    plain version."""
    k = _taps(kernel)
    gpad = grad_pad(k.shape, up, pad, tuple(in_shape[2:]))
    dx = _launch(grad, np.ascontiguousarray(k[::-1, ::-1]), 1, up, gpad,
                 "upfirdn2d_bwd_cuda")
    if tuple(dx.shape) != tuple(in_shape):
        raise ValueError(f"upfirdn2d_bwd_cuda: gradient of shape {tuple(dx.shape)} "
                         f"for an input of {tuple(in_shape)}")
    upfirdn2d_bwd_cuda.launches += 1
    upfirdn2d_bwd_cuda.down2_launches += int(up == 2)
    return dx


upfirdn2d_bwd_cuda.launches = 0
upfirdn2d_bwd_cuda.down2_launches = 0


class _Upfirdn2dCUDA(torch.autograd.Function):
    """K1 forward; its backward is K1 again (:func:`upfirdn2d_bwd_cuda`).
    Only the input gets a gradient: the taps are constants."""

    @staticmethod
    def forward(ctx, x, kernel, up, pad):
        ctx.kernel, ctx.up, ctx.pad, ctx.in_shape = kernel, up, pad, tuple(x.shape)
        return upfirdn2d_cuda(x, kernel, up, pad)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        dx = upfirdn2d_bwd_cuda(grad.contiguous(), ctx.kernel, ctx.up, ctx.pad,
                                ctx.in_shape)
        return dx, None, None, None


def upfirdn2d_fir(x: torch.Tensor, kernel, up: int,
                  pad: Tuple[int, ...]) -> torch.Tensor:
    """upfirdn2d with up in {1, 2}, down 1: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.is_cuda:
        return _Upfirdn2dCUDA.apply(x, kernel, up, pad)
    if x.device.type != "cpu":
        raise ValueError(f"upfirdn2d runs on cuda or cpu, not {x.device}")
    return upfirdn2d_plain(x, kernel, up=up, down=1, pad=pad)
