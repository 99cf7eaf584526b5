"""StyleGAN2 generator, discriminator and W+ encoder as ``nn.Module``s,
computing in NCHW.

PyTorch counterpart of ``stylegan_directions_face_reenactment_tpu/models/
stylegan2.py``. The discriminator and the W+ ResNet encoder
(:class:`Discriminator`, :class:`WPlusEncoder`, the reference's
``model.py:542-710``) are off the serving path; their downsampling blurs go
through K1 (pads (2, 2) before a 3×3 stride-2 conv, (1, 1) before the 1×1
skip) and their activations through K2, at rank 2 in the final linear. The
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

from ..ops import (blur, equal_conv2d, equal_linear, fused_leaky_relu, make_kernel,
                   modulated_conv2d, pixel_norm, scaled_leaky_relu, upsample2d)
from ..ops.upfirdn2d import kernel_array
from ..ops.upfirdn2d_kernel import taps_of

BLUR_KERNEL = (1, 3, 3, 1)
_RGB_UP_KERNEL = taps_of(kernel_array(BLUR_KERNEL, gain=4))   # K1's constant taps


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

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


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


# ---------------------------------------------------------------------------
# Discriminator / W+ encoder (`model.py:542-710`), off the serving path
# ---------------------------------------------------------------------------

class Blur(nn.Module):
    """FIR blur (K1) with the reference's ``kernel`` buffer (the taps,
    normalized) and a fixed pad."""

    def __init__(self, kernel=BLUR_KERNEL, pad: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.register_buffer("kernel", make_kernel(kernel))
        self.pad = pad

    def forward(self, x):
        return blur(x, self.kernel, self.pad)


class EqualConv2d(nn.Module):
    """Equalized-LR conv, weight OIHW at unit scale."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return equal_conv2d(x, self.weight, self.bias, stride=self.stride,
                            padding=self.padding)


class ScaledLeakyReLU(nn.Module):
    def forward(self, x):
        return scaled_leaky_relu(x)


class ConvLayer(nn.Sequential):
    """[Blur →] equalized conv → activation (``model.py:542-588``); with
    ``downsample`` the blur pads ((p + 1) // 2, p // 2), p = 2 + k − 1, and
    the conv has stride 2. Keys as the reference's: ``0.kernel``,
    ``1.weight``, ``2.bias`` (downsampling) or ``0.weight``, ``1.bias``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, downsample: bool = False,
                 bias: bool = True, activate: bool = True):
        layers = []
        if downsample:
            p = (len(BLUR_KERNEL) - 2) + (kernel_size - 1)
            layers.append(Blur(BLUR_KERNEL, pad=((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                                  bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(out_ch) if bias else ScaledLeakyReLU())
        super().__init__(*layers)


def conv_layer(m: ConvLayer, x: torch.Tensor) -> torch.Tensor:
    """A ConvLayer on NCHW x: [blur (K1) →] equalized conv → bias and
    activation (K2), or the scaled activation without a bias."""
    return m(x)


class ResBlock(nn.Module):
    """conv1 (3×3) → conv2 (3×3, downsample), plus a 1×1 downsampling skip
    without activation, summed and scaled by 1/√2."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, in_ch, 3)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=True)
        self.skip = ConvLayer(in_ch, out_ch, 1, downsample=True, activate=False, bias=False)

    def forward(self, x):
        return res_block(self, x)


def res_block(m: ResBlock, x: torch.Tensor) -> torch.Tensor:
    """A ResBlock on NCHW x: (conv2(conv1(x)) + skip(x)) / √2."""
    return (conv_layer(m.conv2, conv_layer(m.conv1, x)) + conv_layer(m.skip, x)) / math.sqrt(2.0)


def _res_trunk(size: int, channels: dict) -> List[nn.Module]:
    """ConvLayer 1×1 from RGB, then a ResBlock a resolution down to 4²."""
    convs = [ConvLayer(3, channels[size], 1)]
    in_ch = channels[size]
    for i in range(int(math.log2(size)), 2, -1):
        out_ch = channels[2 ** (i - 1)]
        convs.append(ResBlock(in_ch, out_ch))
        in_ch = out_ch
    return convs


def minibatch_stddev(x: torch.Tensor, group_size: int = 4, num_feat: int = 1) -> torch.Tensor:
    """Append the minibatch-stddev feature map (``model.py:657-664``): the
    standard deviation over groups of ``min(B, group_size)`` images,
    averaged over channels and pixels. x NCHW."""
    b, c, h, w = x.shape
    group = min(b, group_size)
    y = x.reshape(group, -1, num_feat, c // num_feat, h, w)
    std = torch.sqrt(y.var(dim=0, unbiased=False) + 1e-8)
    std = std.mean(dim=(2, 3, 4), keepdim=True).squeeze(2)      # (B/g, nf, 1, 1)
    return torch.cat([x, std.repeat(group, 1, h, w)], dim=1)


class Discriminator(nn.Module):
    """The reference's StyleGAN2 discriminator (``convs``, ``final_conv``,
    ``final_linear``)."""

    def __init__(self, size: int = 256, channel_multiplier: int = 2):
        super().__init__()
        channels = channel_map(channel_multiplier)
        self.size = size
        self.convs = nn.Sequential(*_res_trunk(size, channels))
        self.final_conv = ConvLayer(channels[4] + 1, channels[4], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(channels[4] * 16, channels[4], activation=True),
            EqualLinear(channels[4], 1))

    def forward(self, x):
        return discriminator_forward(self, x)


def discriminator_forward(d: Discriminator, x: torch.Tensor) -> torch.Tensor:
    """x (B, size, size, 3) NHWC in [-1, 1] → logits (B, 1). The flatten
    before ``final_linear`` is NCHW's, as the reference's."""
    out = d.convs(x.permute(0, 3, 1, 2).contiguous())
    out = d.final_conv(minibatch_stddev(out))
    return d.final_linear(out.reshape(out.shape[0], -1))


WPLUS_CHANNELS = channel_map(1)


class WPlusEncoder(nn.Module):
    """The W+ ResNet encoder (``model.py:673-710``, unused by the
    pipeline): the discriminator's trunk at channel multiplier 1, then a
    4×4 equalized conv to n_latent·w_dim (``convs.{last}``)."""

    def __init__(self, size: int = 256, w_dim: int = 512):
        super().__init__()
        self.n_latents, self.w_dim = n_latent_for(size), w_dim
        convs = _res_trunk(size, WPLUS_CHANNELS)
        convs.append(EqualConv2d(WPLUS_CHANNELS[4], self.n_latents * w_dim, 4, bias=False))
        self.convs = nn.Sequential(*convs)

    def forward(self, x):
        return wplus_encoder_forward(self, x)


def wplus_encoder_forward(e: WPlusEncoder, x: torch.Tensor) -> torch.Tensor:
    """x (B, size, size, 3) NHWC → W+ (B, n_latent, w_dim)."""
    return e.convs(x.permute(0, 3, 1, 2).contiguous()).reshape(x.shape[0], e.n_latents,
                                                               e.w_dim)
