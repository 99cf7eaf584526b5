"""K2: fused bias + LeakyReLU + gain, the StyleGAN2 activation.

    y = leaky_relu(x + b[c], negative_slope) * scale

with ``negative_slope = 0.2`` and ``scale = sqrt(2)`` everywhere in the
pipeline. The bias lies on dim 1, which covers (B, C) and NCHW (B, C, H, W).

Replaces the Pallas TPU kernels ``stylegan_directions_face_reenactment_tpu/
ops/fused_act.py::_pallas_fwd_call`` (entered through ``_fused_fwd`` and
``fused_leaky_relu_pallas``) and ``_pallas_bwd_call`` (K2-bwd, entered
through ``_fused_bwd``). On the serving path the forward is the activation
of the 13 StyledConvs, so it runs 13 times a request; the mapping network's
8 layers run it at set-up (``mean_latent``, the source's W). A PTI step of
source set-up runs the backward on the 8 tuned StyledConvs ``convs[4..11]``.

Bound on an H100: device-memory bytes (forward: one read of x, one write of
y; backward: reads of g and y, one write of dx). Without the kernel eager
PyTorch would make three passes (add, activation, gain); the source
(``csrc/fused_bias_act.cu``) says what its design does.

* :func:`fused_leaky_relu_plain` is the plain PyTorch version of the
  forward and :func:`fused_leaky_relu_bwd_plain` that of the backward.
* ``sdfr::fused_bias_act`` and ``sdfr::fused_bias_act_bwd``
  (``fused_bias_act_op``, ``fused_bias_act_bwd_op``) are the
  registered operators that :func:`fused_leaky_relu`, the eager paths and
  an exported graph call: each runs its plain version on a CPU tensor and
  its kernel on a CUDA tensor (no other device has an implementation), and
  gives shapes alone under fake tensors (``torch.export``).
* :func:`fused_bias_act_cuda` launches the forward and counts its launches
  in ``fused_bias_act_cuda.launches``; :func:`fused_bias_act_bwd_cuda`
  launches the backward and counts in ``fused_bias_act_bwd_cuda.launches``.
* The forward's autograd formula saves only the output y and takes the mask from its sign, as
  the JAX package's ``_bwd_kernel`` does; the bias gradient is a PyTorch
  sum of dx over every dim but 1 (:func:`bias_grad`), as the JAX package
  sums outside its kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .kernel_build import check, load_library, on_card_of, register_autograd, register_op

DEFAULT_SLOPE = 0.2
DEFAULT_SCALE = math.sqrt(2.0)
_ENTRY = {torch.float32: "fused_bias_act_f32", torch.bfloat16: "fused_bias_act_bf16"}
_BWD_ENTRY = {torch.float32: "fused_bias_act_bwd_f32",
              torch.bfloat16: "fused_bias_act_bwd_bf16"}


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
    with on_card_of(x):
        status = fn(x.data_ptr(), b_ptr, y.data_ptr(), x.numel(), c, inner,
                    float(negative_slope), float(scale),
                    torch.cuda.current_stream(x.device).cuda_stream)
    check(status, "fused_bias_act_cuda")
    fused_bias_act_cuda.launches += 1
    return y


fused_bias_act_cuda.launches = 0


def _gains(negative_slope: float, scale: float):
    """(scale, scale·slope) as float32 values: the factors dx takes where
    y >= 0 and elsewhere, formed once in double precision."""
    return float(np.float32(scale)), float(np.float32(scale * negative_slope))


def fused_leaky_relu_bwd_plain(g: torch.Tensor, y: torch.Tensor,
                               negative_slope: float = DEFAULT_SLOPE,
                               scale: float = DEFAULT_SCALE) -> torch.Tensor:
    """Plain version of the backward: dx = g·scale where the saved output
    y >= 0, g·scale·slope elsewhere, in float32, rounded once to
    ``g.dtype``."""
    pos, neg = _gains(negative_slope, scale)
    gain = torch.where(y.float() >= 0, pos, neg)
    return (g.float() * gain).to(g.dtype)


def bias_grad(dx: torch.Tensor) -> torch.Tensor:
    """The bias gradient: dx summed over every dim but the channel dim 1."""
    return dx.sum(dim=[0] + list(range(2, dx.dim())))


def fused_bias_act_bwd_cuda(g: torch.Tensor, y: torch.Tensor,
                            negative_slope: float = DEFAULT_SLOPE,
                            scale: float = DEFAULT_SCALE) -> torch.Tensor:
    """Launch K2-bwd on contiguous CUDA tensors g and y of one shape and
    dtype (f32 or bf16): dx of :func:`fused_bias_act_cuda` from its output
    y and the output's gradient g."""
    if not (g.is_cuda and y.is_cuda):
        raise ValueError("fused_bias_act_bwd_cuda takes CUDA tensors")
    if g.dtype not in _BWD_ENTRY or y.dtype != g.dtype:
        raise TypeError(f"fused_bias_act_bwd_cuda takes float32 or bfloat16 g and y of "
                        f"one dtype, got {g.dtype} and {y.dtype}")
    if g.shape != y.shape or not (g.is_contiguous() and y.is_contiguous()) \
            or g.numel() == 0:
        raise ValueError("fused_bias_act_bwd_cuda takes non-empty contiguous g and y "
                         f"of one shape, got {tuple(g.shape)} and {tuple(y.shape)}")
    pos, neg = _gains(negative_slope, scale)
    dx = torch.empty_like(g)
    fn = getattr(load_library(), _BWD_ENTRY[g.dtype])
    with on_card_of(g):
        status = fn(g.data_ptr(), y.data_ptr(), dx.data_ptr(), g.numel(), pos, neg,
                    torch.cuda.current_stream(g.device).cuda_stream)
    check(status, "fused_bias_act_bwd_cuda")
    fused_bias_act_bwd_cuda.launches += 1
    return dx


fused_bias_act_bwd_cuda.launches = 0


# --- the operators: what the eager paths and an exported graph call ----------

def _fake(x, *_):
    return torch.empty_like(x)


# K2 as a registered operator: the plain version on the CPU, the kernel on
# the card (fused_bias_act_cuda), shapes only under fake tensors; its
# autograd formula is fused_bias_act_bwd and bias_grad
fused_bias_act_op = register_op(
    "fused_bias_act(Tensor x, Tensor? bias, float negative_slope, float scale) -> Tensor",
    fused_leaky_relu_plain, fused_bias_act_cuda, _fake)
# K2-bwd: dx from the forward's output y and its gradient g
fused_bias_act_bwd_op = register_op(
    "fused_bias_act_bwd(Tensor g, Tensor y, float negative_slope, float scale) -> Tensor",
    fused_leaky_relu_bwd_plain, fused_bias_act_bwd_cuda, _fake)


def _setup(ctx, inputs, output):
    _, bias, ctx.negative_slope, ctx.scale = inputs
    ctx.bias_dtype = None if bias is None else bias.dtype
    ctx.save_for_backward(output)


def _backward(ctx, grad):
    """K2-bwd on the saved output; the bias's gradient is :func:`bias_grad`
    of its dx."""
    (y,) = ctx.saved_tensors
    dx = fused_bias_act_bwd_op(grad.contiguous(), y, ctx.negative_slope, ctx.scale)
    db = bias_grad(dx).to(ctx.bias_dtype) if ctx.needs_input_grad[1] else None
    return dx if ctx.needs_input_grad[0] else None, db, None, None


register_autograd(fused_bias_act_op, _backward, setup_context=_setup)


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = DEFAULT_SLOPE,
                     scale: float = DEFAULT_SCALE) -> torch.Tensor:
    """``leaky_relu(x + bias) * scale``, bias on dim 1, through the operator:
    the kernel for a CUDA tensor (made contiguous), the plain version for a
    CPU tensor."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_leaky_relu runs on cuda or cpu, not {x.device}")
    if x.is_cuda:
        x = x.contiguous()
    return fused_bias_act_op(x, bias, float(negative_slope), float(scale))


def scaled_leaky_relu(x: torch.Tensor,
                      negative_slope: float = DEFAULT_SLOPE) -> torch.Tensor:
    """Bias-free variant (the reference's ScaledLeakyReLU); off the serving
    path, so plain PyTorch as the JAX package's jnp form."""
    return torch.where(x >= 0, x, x * negative_slope) * math.sqrt(2.0)
