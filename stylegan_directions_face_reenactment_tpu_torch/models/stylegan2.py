"""StyleGAN2 generator as ``nn.Module``s, computing in NCHW.

PyTorch counterpart of the generator half of
``stylegan_directions_face_reenactment_tpu/models/stylegan2.py``. The
modules hold the parameters, named like the reference's ``model.py``
(``style.N``, ``input.input``, ``conv1``, ``to_rgb1``, ``convs.N``,
``to_rgbs.N``, ``noises.noise_N``); the functions below hold the forward
math, with the JAX package's names. Noise buffers are fixed (the reference
registers them as buffers and defaults to ``randomize_noise=False``), which
makes synthesis deterministic.

Layouts at the edges are the JAX package's: :func:`synthesis` and
:func:`generator_forward` return NHWC images in [-1, 1]; latents are
(B, n_latent, 512). Weights: conv (out, in, kh, kw), linear (out, in).

``compute_dtype=torch.bfloat16`` runs the whole synthesis in bf16 (the noise
add keeps the activation dtype). The JAX package's bf16 synthesis promotes
to f32 at the first noise add (its f32 ``noise_weight`` times bf16 noise),
so the two agree bit for bit only in f32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops import (equal_linear, fused_leaky_relu, make_kernel,
                   modulated_conv2d, pixel_norm, upsample2d)

BLUR_KERNEL = (1, 3, 3, 1)
_RGB_UP_KERNEL = make_kernel(BLUR_KERNEL, gain=4)


def channel_map(channel_multiplier: int = 2) -> dict:
    """Per-resolution channel table of the reference."""
    return {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }


def n_latent_for(size: int) -> int:
    """Number of W+ rows: 2*log2(size) - 2; 14 at 256."""
    return int(math.log2(size)) * 2 - 2


def num_noise_layers(size: int) -> int:
    return (int(math.log2(size)) - 2) * 2 + 1


# ---------------------------------------------------------------------------
# Parameter modules
# ---------------------------------------------------------------------------

class PixelNorm(nn.Module):
    def forward(self, x):
        return pixel_norm(x)


class EqualLinear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, lr_mul: float = 1.0,
                 bias_init: float = 0.0, activation: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim))
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init)))
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x):
        return equal_linear(x, self.weight, self.bias, self.lr_mul,
                            self.activation)


class ModulatedConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 style_dim: int, demodulate: bool = True,
                 upsample: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(out_ch, in_ch, kernel_size, kernel_size))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0)
        self.demodulate = demodulate
        self.upsample = upsample


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))


class StyledConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 style_dim: int, upsample: bool = False):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, kernel_size, style_dim,
                                    upsample=upsample)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_ch)


class ToRGB(nn.Module):
    def __init__(self, in_ch: int, style_dim: int):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))


class ConstantInput(nn.Module):
    def __init__(self, channels: int, size: int = 4):
        super().__init__()
        self.input = nn.Parameter(torch.zeros(1, channels, size, size))


class NoiseBuffers(nn.Module):
    """Fixed per-layer noise maps ``noise_i`` of shape (1, 1, R, R)."""

    def __init__(self, size: int):
        super().__init__()
        self.num_layers = num_noise_layers(size)
        for i in range(self.num_layers):
            res = 2 ** ((i + 5) // 2)
            self.register_buffer(f"noise_{i}", torch.zeros(1, 1, res, res))

    def as_list(self) -> List[torch.Tensor]:
        return [getattr(self, f"noise_{i}") for i in range(self.num_layers)]


class Generator(nn.Module):
    """StyleGAN2 generator; parameters start at zero, see
    ``weights/from_jax.py`` for the seeded init and the JAX weight import."""

    def __init__(self, size: int = 256, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2):
        super().__init__()
        self.size, self.style_dim = size, style_dim
        self.n_mlp, self.channel_multiplier = n_mlp, channel_multiplier
        self.n_latent = n_latent_for(size)
        channels = channel_map(channel_multiplier)
        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinear(style_dim, style_dim, lr_mul=0.01, activation=True)
            for _ in range(n_mlp)])
        self.input = ConstantInput(channels[4])
        self.conv1 = StyledConv(channels[4], channels[4], 3, style_dim)
        self.to_rgb1 = ToRGB(channels[4], style_dim)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = channels[4]
        for i in range(3, int(math.log2(size)) + 1):
            out_ch = channels[2 ** i]
            self.convs.append(StyledConv(in_ch, out_ch, 3, style_dim, upsample=True))
            self.convs.append(StyledConv(out_ch, out_ch, 3, style_dim))
            self.to_rgbs.append(ToRGB(out_ch, style_dim))
            in_ch = out_ch
        self.noises = NoiseBuffers(size)

    def forward(self, styles, **kwargs):
        return generator_forward(self, styles, **kwargs)


# ---------------------------------------------------------------------------
# Forward math
# ---------------------------------------------------------------------------

def modconv_apply(m: ModulatedConv2d, x: torch.Tensor,
                  w_style: torch.Tensor) -> torch.Tensor:
    s = equal_linear(w_style, m.modulation.weight, m.modulation.bias)
    return modulated_conv2d(x, m.weight, s, demodulate=m.demodulate,
                            upsample=m.upsample, blur_kernel=BLUR_KERNEL)


def styled_conv(m: StyledConv, x: torch.Tensor, w_style: torch.Tensor,
                noise: Optional[torch.Tensor]) -> torch.Tensor:
    """ModulatedConv → noise add → fused leaky relu (K2)."""
    out = modconv_apply(m.conv, x, w_style)
    if noise is not None:
        out = out + m.noise.weight.to(out.dtype) * noise.to(out.dtype)
    return fused_leaky_relu(out, m.activate.bias)


def to_rgb(m: ToRGB, x: torch.Tensor, w_style: torch.Tensor,
           skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1 modulated conv (no demod) + bias + upsampled skip (K1)."""
    out = modconv_apply(m.conv, x, w_style) + m.bias.to(x.dtype)
    if skip is not None:
        out = out + upsample2d(skip, _RGB_UP_KERNEL).to(out.dtype)
    return out


def mapping(g: Generator, z: torch.Tensor) -> torch.Tensor:
    """Style MLP: PixelNorm + n_mlp equalized fused-lrelu layers."""
    return g.style(z)


def mean_latent(g: Generator, rng: torch.Generator,
                n_latent: int = 4096) -> torch.Tensor:
    """Mean W over ``n_latent`` random z's, for truncation; the z's come
    from ``rng`` (a CPU ``torch.Generator``) and are mapped on g's device."""
    z = torch.randn(n_latent, g.style_dim, generator=rng)
    return mapping(g, z.to(g.input.input.device)).mean(dim=0, keepdim=True)


def synthesis(g: Generator, latent: torch.Tensor,
              noise: Optional[List[Optional[torch.Tensor]]] = None,
              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """W+ latent (B, n_latent, 512) → NHWC float32 image in [-1, 1]."""
    if noise is None:
        noise = g.noises.as_list()
    b = latent.shape[0]
    out = g.input.input.to(compute_dtype).expand(b, -1, -1, -1)
    latent = latent.to(compute_dtype)

    out = styled_conv(g.conv1, out, latent[:, 0], noise[0])
    skip = to_rgb(g.to_rgb1, out, latent[:, 1])
    i = 1
    for idx in range(0, len(g.convs), 2):
        out = styled_conv(g.convs[idx], out, latent[:, i], noise[idx + 1])
        out = styled_conv(g.convs[idx + 1], out, latent[:, i + 1], noise[idx + 2])
        skip = to_rgb(g.to_rgbs[idx // 2], out, latent[:, i + 2], skip)
        i += 2
    return skip.float().permute(0, 2, 3, 1)


def style_to_wplus(g: Generator, styles: Sequence[torch.Tensor],
                   inject_index: Optional[int] = None) -> torch.Tensor:
    """W (or a pair of W for mixing) → W+ (B, n_latent, 512)."""
    n_lat = g.n_latent
    if len(styles) < 2:
        s = styles[0]
        if s.dim() < 3:
            return s[:, None, :].repeat(1, n_lat, 1)
        return s
    if inject_index is None:
        raise ValueError("style mixing requires an explicit inject_index")
    l1 = styles[0][:, None, :].repeat(1, inject_index, 1)
    l2 = styles[1][:, None, :].repeat(1, n_lat - inject_index, 1)
    return torch.cat([l1, l2], dim=1)


def generator_forward(g: Generator, styles: Sequence[torch.Tensor], *,
                      input_is_latent: bool = False,
                      truncation: float = 1.0,
                      truncation_latent: Optional[torch.Tensor] = None,
                      inject_index: Optional[int] = None,
                      return_latents: bool = False,
                      noise: Optional[List[Optional[torch.Tensor]]] = None,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The reference ``Generator.forward``: styles is a list of (B, 512) z/w
    vectors or a single (B, n_latent, 512) W+. Returns (NHWC image, W+ or
    None). Noise defaults to the fixed buffers; truncation applies to every
    style."""
    if not input_is_latent:
        styles = [mapping(g, s) for s in styles]
    if truncation < 1:
        if truncation_latent is None:
            raise ValueError("truncation < 1 requires truncation_latent")
        styles = [truncation_latent + truncation * (s - truncation_latent)
                  for s in styles]
    latent = style_to_wplus(g, styles, inject_index)
    image = synthesis(g, latent, noise, compute_dtype=compute_dtype)
    return image, (latent if return_latents else None)
