"""K2: fused bias + LeakyReLU + gain, the StyleGAN2 activation.

    y = leaky_relu(x + b[c], negative_slope) * scale

with ``negative_slope = 0.2`` and ``scale = sqrt(2)`` everywhere in the
pipeline. The bias lies on dim 1, which covers (B, C) and NCHW (B, C, H, W).

Replaces the Pallas TPU kernel ``stylegan_directions_face_reenactment_tpu/
ops/fused_act.py::_pallas_fwd_call`` (entered through ``_fused_fwd`` and
``fused_leaky_relu_pallas``). On the serving path it is the activation of
the 13 StyledConvs, so it runs 13 times a request; the mapping network's 8
layers run it at set-up (``mean_latent``, the source's W).

Bound on an H100: device-memory bytes (one read of x, one write of y).
Without the kernel eager PyTorch would make three passes (add, activation,
gain); the source (``csrc/fused_bias_act.cu``) says what its design does.

* :func:`fused_leaky_relu_plain` is the plain PyTorch version of the same
  function; :func:`fused_leaky_relu` takes it only for CPU tensors.
* :func:`fused_bias_act_cuda` launches the kernel and counts its launches in
  ``fused_bias_act_cuda.launches``.
* The kernel is forward only; its backward (the JAX package's
  ``_pallas_bwd_call``) comes with the PTI/training slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .kernel_build import check, load_library

DEFAULT_SLOPE = 0.2
DEFAULT_SCALE = math.sqrt(2.0)
_ENTRY = {torch.float32: "fused_bias_act_f32", torch.bfloat16: "fused_bias_act_bf16"}


def _bias_view(bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return bias.reshape((1, -1) + (1,) * (x.dim() - 2))


def fused_leaky_relu_plain(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                           negative_slope: float = DEFAULT_SLOPE,
                           scale: float = DEFAULT_SCALE) -> torch.Tensor:
    """Plain version: the kernel's arithmetic in float32, rounded once to
    ``x.dtype``."""
    v = x.float()
    if bias is not None:
        v = v + _bias_view(bias.to(x.dtype).float(), x)
    return (torch.where(v >= 0, v, v * negative_slope) * scale).to(x.dtype)


def fused_bias_act_cuda(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        negative_slope: float = DEFAULT_SLOPE,
                        scale: float = DEFAULT_SCALE) -> torch.Tensor:
    """Launch K2 on a contiguous CUDA tensor of rank >= 2 (f32 or bf16)."""
    if not x.is_cuda:
        raise ValueError("fused_bias_act_cuda takes a CUDA tensor")
    if x.dtype not in _ENTRY:
        raise TypeError(f"fused_bias_act_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("fused_bias_act_cuda takes a non-empty contiguous "
                         "tensor of rank >= 2")
    c = x.shape[1]
    inner = x.numel() // (x.shape[0] * c)
    b_ptr = None
    if bias is not None:
        if bias.numel() != c or bias.device != x.device:
            raise ValueError(f"bias must hold {c} values on {x.device}")
        bias = bias.to(x.dtype).contiguous()
        b_ptr = bias.data_ptr()
    y = torch.empty_like(x)
    fn = getattr(load_library(), _ENTRY[x.dtype])
    status = fn(x.data_ptr(), b_ptr, y.data_ptr(), x.numel(), c, inner,
                float(negative_slope), float(scale),
                torch.cuda.current_stream(x.device).cuda_stream)
    check(status, "fused_bias_act_cuda")
    fused_bias_act_cuda.launches += 1
    return y


fused_bias_act_cuda.launches = 0


class _FusedBiasActCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        return fused_bias_act_cuda(x, bias, negative_slope, scale)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the fused bias-act CUDA kernel is forward only; its backward "
            "comes with the PTI/training slice")


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = DEFAULT_SLOPE,
                     scale: float = DEFAULT_SCALE) -> torch.Tensor:
    """``leaky_relu(x + bias) * scale``, bias on dim 1: the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return _FusedBiasActCUDA.apply(x, bias, negative_slope, scale)
    if x.device.type != "cpu":
        raise ValueError(f"fused_leaky_relu runs on cuda or cpu, not {x.device}")
    return fused_leaky_relu_plain(x, bias, negative_slope, scale)


def scaled_leaky_relu(x: torch.Tensor,
                      negative_slope: float = DEFAULT_SLOPE) -> torch.Tensor:
    """Bias-free variant (the reference's ScaledLeakyReLU); off the serving
    path, so plain PyTorch as the JAX package's jnp form."""
    return torch.where(x >= 0, x, x * negative_slope) * math.sqrt(2.0)
