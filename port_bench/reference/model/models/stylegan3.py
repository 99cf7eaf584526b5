"""StyleGAN3-T in plain PyTorch, float32, from NVlabs/stylegan3
``training/networks_stylegan3.py`` (Karras et al. 2021): ``FullyConnectedLayer``,
``MappingNetwork`` (no labels; the port's mean latent takes the place of
``w_avg``), ``SynthesisInput``, ``SynthesisLayer`` (``modulated_conv2d`` as
NVlabs writes it: per-sample weights and a grouped convolution) and
``SynthesisNetwork``, with NVlabs' ``G_ema`` state-dict names.

Departures: every layer computes in float32 (NVlabs runs the four highest
resolutions in fp16; the clamp at 256 is kept); the mapping's truncation
and ``w_avg`` are not used (the pipeline truncates against a mean over
4096 z's); the filters come from ``scipy.signal.firwin`` as NVlabs designs
them. :func:`synthesis` runs one frame at a time, so that the upsampled
planes of the 1024² layers fit beside the rest."""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.signal
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.filtered_lrelu import filtered_lrelu_ref


class FullyConnectedLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int, activation: str = "linear",
                 lr_multiplier: float = 1.0, bias_init=0.0):
        super().__init__()
        self.activation = activation
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        bias = np.broadcast_to(np.asarray(bias_init, dtype=np.float32), [out_features])
        self.bias = nn.Parameter(torch.tensor(bias / lr_multiplier))
        self.weight_gain = lr_multiplier / np.sqrt(in_features)
        self.bias_gain = lr_multiplier

    def forward(self, x):
        w = self.weight * self.weight_gain
        b = self.bias * self.bias_gain
        if self.activation == "linear":
            return torch.addmm(b.unsqueeze(0), x, w.t())
        return F.leaky_relu(x.matmul(w.t()) + b, 0.2) * np.sqrt(2)


class MappingNetwork(nn.Module):
    def __init__(self, z_dim: int = 512, w_dim: int = 512, num_layers: int = 2,
                 lr_multiplier: float = 0.01):
        super().__init__()
        self.num_layers = num_layers
        for idx in range(num_layers):
            setattr(self, f"fc{idx}", FullyConnectedLayer(z_dim if idx == 0 else w_dim, w_dim,
                                                          "lrelu", lr_multiplier))
        self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, z):
        x = z.to(torch.float32)
        x = x * (x.square().mean(1, keepdim=True) + 1e-8).rsqrt()
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)
        return x


def modulated_conv2d(x, w, s, demodulate=True, padding=0, input_gain=None):
    batch_size = int(x.shape[0])
    out_channels, in_channels, kh, kw = w.shape
    if demodulate:
        w = w * w.square().mean([1, 2, 3], keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
    w = w.unsqueeze(0) * s.unsqueeze(1).unsqueeze(3).unsqueeze(4)
    if demodulate:
        dcoefs = (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()
        w = w * dcoefs.unsqueeze(2).unsqueeze(3).unsqueeze(4)
    if input_gain is not None:
        input_gain = input_gain.expand(batch_size, in_channels)
        w = w * input_gain.unsqueeze(1).unsqueeze(3).unsqueeze(4)
    x = x.reshape(1, -1, *x.shape[2:])
    w = w.reshape(-1, in_channels, kh, kw)
    x = F.conv2d(x, w.to(x.dtype), padding=padding, groups=batch_size)
    return x.reshape(batch_size, -1, *x.shape[2:])


class SynthesisInput(nn.Module):
    def __init__(self, w_dim, channels, size, sampling_rate, bandwidth):
        super().__init__()
        self.w_dim, self.channels = w_dim, channels
        self.size = np.broadcast_to(np.asarray(size), [2])
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        self.weight = nn.Parameter(torch.zeros(channels, channels))
        self.affine = FullyConnectedLayer(w_dim, 4, bias_init=[1, 0, 0, 0])
        self.register_buffer("transform", torch.eye(3, 3))
        self.register_buffer("freqs", torch.zeros(channels, 2))
        self.register_buffer("phases", torch.zeros(channels))

    def forward(self, w):
        transforms = self.transform.unsqueeze(0)
        freqs = self.freqs.unsqueeze(0)
        phases = self.phases.unsqueeze(0)
        t = self.affine(w)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        m_r = torch.eye(3, device=w.device).unsqueeze(0).repeat([w.shape[0], 1, 1])
        m_r[:, 0, 0] = t[:, 0]
        m_r[:, 0, 1] = -t[:, 1]
        m_r[:, 1, 0] = t[:, 1]
        m_r[:, 1, 1] = t[:, 0]
        m_t = torch.eye(3, device=w.device).unsqueeze(0).repeat([w.shape[0], 1, 1])
        m_t[:, 0, 2] = -t[:, 2]
        m_t[:, 1, 2] = -t[:, 3]
        transforms = m_r @ m_t @ transforms
        phases = phases + (freqs @ transforms[:, :2, 2:]).squeeze(2)
        freqs = freqs @ transforms[:, :2, :2]
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)
        theta = torch.eye(2, 3, device=w.device)
        theta[0, 0] = 0.5 * self.size[0] / self.sampling_rate
        theta[1, 1] = 0.5 * self.size[1] / self.sampling_rate
        grids = F.affine_grid(theta.unsqueeze(0), [1, 1, self.size[1], self.size[0]],
                              align_corners=False)
        x = (grids.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1).unsqueeze(2)).squeeze(3)
        x = x + phases.unsqueeze(1).unsqueeze(2)
        x = torch.sin(x * (np.pi * 2))
        x = x * amplitudes.unsqueeze(1).unsqueeze(2)
        weight = self.weight / np.sqrt(self.channels)
        x = x @ weight.t()
        return x.permute(0, 3, 1, 2)


def design_lowpass_filter(numtaps, cutoff, width, fs):
    if numtaps == 1:
        return None
    f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
    return torch.as_tensor(f, dtype=torch.float32)


class SynthesisLayer(nn.Module):
    def __init__(self, w_dim, is_torgb, in_channels, out_channels, in_size, out_size,
                 in_sampling_rate, out_sampling_rate, in_cutoff, out_cutoff, in_half_width,
                 out_half_width, conv_kernel=3, filter_size=6, lrelu_upsampling=2,
                 conv_clamp=256):
        super().__init__()
        self.is_torgb = is_torgb
        self.in_channels, self.out_channels = in_channels, out_channels
        self.in_size = np.broadcast_to(np.asarray(in_size), [2])
        self.out_size = np.broadcast_to(np.asarray(out_size), [2])
        self.out_sampling_rate = out_sampling_rate
        self.tmp_sampling_rate = max(in_sampling_rate, out_sampling_rate) * (
            1 if is_torgb else lrelu_upsampling)
        self.conv_kernel = 1 if is_torgb else conv_kernel
        self.conv_clamp = conv_clamp
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, self.conv_kernel,
                                               self.conv_kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("magnitude_ema", torch.ones([]))
        self.up_factor = int(np.rint(self.tmp_sampling_rate / in_sampling_rate))
        self.up_taps = filter_size * self.up_factor if self.up_factor > 1 and not is_torgb else 1
        self.register_buffer("up_filter", design_lowpass_filter(
            self.up_taps, in_cutoff, in_half_width * 2, self.tmp_sampling_rate))
        self.down_factor = int(np.rint(self.tmp_sampling_rate / out_sampling_rate))
        self.down_taps = (filter_size * self.down_factor
                          if self.down_factor > 1 and not is_torgb else 1)
        self.register_buffer("down_filter", design_lowpass_filter(
            self.down_taps, out_cutoff, out_half_width * 2, self.tmp_sampling_rate))
        pad_total = (self.out_size - 1) * self.down_factor + 1
        pad_total -= (self.in_size + self.conv_kernel - 1) * self.up_factor
        pad_total += self.up_taps + self.down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo[0]), int(pad_hi[0]), int(pad_lo[1]), int(pad_hi[1])]

    def forward(self, x, w):
        input_gain = self.magnitude_ema.rsqrt()
        styles = self.affine(w)
        if self.is_torgb:
            styles = styles * (1 / np.sqrt(self.in_channels * (self.conv_kernel ** 2)))
        x = modulated_conv2d(x, self.weight, styles, demodulate=not self.is_torgb,
                             padding=self.conv_kernel - 1, input_gain=input_gain)
        gain = 1 if self.is_torgb else np.sqrt(2)
        slope = 1 if self.is_torgb else 0.2
        return filtered_lrelu_ref(x, self.up_filter, self.down_filter, self.bias,
                                  self.up_factor, self.down_factor, self.padding, gain, slope,
                                  self.conv_clamp)


class SynthesisNetwork(nn.Module):
    def __init__(self, w_dim=512, img_resolution=1024, img_channels=3, channel_base=32768,
                 channel_max=512, num_layers=14, num_critical=2, first_cutoff=2,
                 first_stopband=2 ** 2.1, last_stopband_rel=2 ** 0.3, margin_size=10,
                 output_scale=0.25, **layer_kwargs):
        super().__init__()
        self.num_ws = num_layers + 2
        self.output_scale = output_scale
        last_cutoff = img_resolution / 2
        last_stopband = last_cutoff * last_stopband_rel
        exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
        cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
        stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
        sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
        half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
        sizes = sampling_rates + margin_size * 2
        sizes[-2:] = img_resolution
        channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
        channels[-1] = img_channels
        self.input = SynthesisInput(w_dim, int(channels[0]), int(sizes[0]), sampling_rates[0],
                                    cutoffs[0])
        self.layer_names = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            layer = SynthesisLayer(
                w_dim, idx == num_layers, int(channels[prev]), int(channels[idx]),
                int(sizes[prev]), int(sizes[idx]), int(sampling_rates[prev]),
                int(sampling_rates[idx]), cutoffs[prev], cutoffs[idx], half_widths[prev],
                half_widths[idx], **layer_kwargs)
            name = f"L{idx}_{layer.out_size[0]}_{layer.out_channels}"
            setattr(self, name, layer)
            self.layer_names.append(name)

    def forward(self, ws):
        ws = ws.to(torch.float32).unbind(dim=1)
        x = self.input(ws[0])
        for name, w in zip(self.layer_names, ws[1:]):
            x = getattr(self, name)(x, w)
        if self.output_scale != 1:
            x = x * self.output_scale
        return x.to(torch.float32)


class Generator(nn.Module):
    """``mapping`` and ``synthesis``; ``n_latent`` W+ rows."""

    def __init__(self, resolution=1024, style_dim=512, mapping_layers=2, **synthesis_kwargs):
        super().__init__()
        self.style_dim = style_dim
        self.mapping = MappingNetwork(style_dim, style_dim, mapping_layers)
        self.synthesis = SynthesisNetwork(style_dim, resolution, **synthesis_kwargs)
        self.n_latent = self.synthesis.num_ws


def mapping(g: Generator, z: torch.Tensor) -> torch.Tensor:
    return g.mapping(z)


def mean_latent(g: Generator, rng: torch.Generator, n_latent: int = 4096) -> torch.Tensor:
    z = torch.randn(n_latent, g.style_dim, generator=rng)
    return mapping(g, z.to(g.synthesis.input.weight.device)).mean(dim=0, keepdim=True)


def style_to_wplus(g: Generator, styles) -> torch.Tensor:
    return styles[0][:, None, :].repeat(1, g.n_latent, 1)


def synthesis(g: Generator, latent: torch.Tensor) -> torch.Tensor:
    """W+ (B, n_latent, 512) → NHWC float32 images, one frame at a time."""
    return torch.cat([g.synthesis(latent[i:i + 1]) for i in range(latent.shape[0])]
                     ).permute(0, 2, 3, 1)
