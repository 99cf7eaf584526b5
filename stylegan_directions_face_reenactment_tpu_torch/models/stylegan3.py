"""StyleGAN3 (alias-free) generator, the T configuration, as ``nn.Module``s
computing on (N, C, H, W) batches kept channels-last, with the functional
interface of ``models/stylegan2.py``.

Written from the published architecture (Karras et al., "Alias-Free
Generative Adversarial Networks", NeurIPS 2021; NVlabs/stylegan3
``training/networks_stylegan3.py``); the JAX package has no StyleGAN3.
Modules and state-dict names are NVlabs' ``G_ema``'s (``mapping.fc0``,
``mapping.w_avg``, ``synthesis.input.{weight,affine,transform,freqs,phases}``,
``synthesis.L{i}_{size}_{channels}.{weight,bias,magnitude_ema,affine,
up_filter,down_filter}``), so a published state dict loads with a plain
``load_state_dict``.

* The mapping is StyleGAN2's style MLP (:class:`stylegan2.EqualLinear`, K2)
  with NVlabs' names: pixel norm, then ``mapping_layers`` equalized
  leaky-ReLU layers at lr 0.01.
* :class:`SynthesisInput`: Fourier features of fixed frequencies and phases,
  turned and shifted by an affine of w[0], then a 1×1 mix.
* :class:`SynthesisLayer`: styles from an affine (bias 1); a modulated conv
  with StyleGAN3's pre-normalisation of weight and styles and an input gain
  of ``magnitude_ema.rsqrt()``, padded by k − 1, no noise; then the filtered
  leaky ReLU (K4, ``ops/filtered_lrelu.py``). The convolution runs on cuDNN
  through the input/output-scaling identity (``ops/modulated_conv.py``):
  conv(x · s · gain, ŵ) · demod. In :func:`synthesis` K4 applies the
  demodulation to its input and the next layer's s · gain to its output,
  so neither is a pass of its own over the planes.
* The activations are channels-last (:data:`MEMORY_FORMAT`) from the
  Fourier input to ToRGB, and so are the normalised conv weights: cuDNN's
  TF32 convolutions run in that layout and K4 reads and writes it, so no
  layout transpose stands between a convolution and its K4 call, and the
  image comes out as a contiguous NHWC tensor. Each layer's channel count
  but ToRGB's 3 is padded to a multiple of :data:`CHANNEL_MULTIPLE` with
  channels that stay exactly zero (zero weight rows and columns, zero bias
  and scales, which K4 filters to zeros): of any other count cuDNN makes a padded copy of its input
  or output each call.
* :func:`layer_schedule`: each layer's cutoff, stopband, sampling rate,
  size and channels from the published formula (14 layers and ToRGB at
  1024², ``L0_36_512`` … ``L14_1024_3``).

The output scale (0.25) is folded into ToRGB's K4 call: its gain and clamp
are scaled by it (clamp(x, 256) · 0.25 = clamp(0.25 · x, 64), exactly in
float). Every layer's filters are designed once at construction (a Kaiser
``firwin``, :func:`design_lowpass_filter`) and kept as Python floats, so a
call reads no tensor on the host. ``compute_dtype=torch.bfloat16`` runs the
convolutions and K4's planes in bf16 (Fourier features, styles and demod in
float32). While a profiler runs, each layer is one ``sg3.layer`` span
(``utils/profiling.py``) with its ``index`` (-1 for the input), sampling
``rate``, ``size`` and ``channels``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import equal_linear, pixel_norm
from ..ops.filtered_lrelu import filtered_lrelu
from .stylegan2 import EqualLinear

# the layout of the synthesis' activations and of its conv weights
MEMORY_FORMAT = torch.channels_last
# the activations' channel counts are padded with zero channels to a multiple
# of this, which cuDNN's channels-last float32 convolutions take as they are
CHANNEL_MULTIPLE = 8


def padded_channels(c: int) -> int:
    """``c`` rounded up to a multiple of :data:`CHANNEL_MULTIPLE`."""
    return -(-c // CHANNEL_MULTIPLE) * CHANNEL_MULTIPLE


def _pad_channels(v: torch.Tensor, c: int) -> torch.Tensor:
    """``v`` (..., C) with zeros appended along its last axis up to ``c``."""
    return v if v.shape[-1] == c else F.pad(v, (0, c - v.shape[-1]))


def _to_layer_input(x: torch.Tensor, m: "SynthesisLayer", dtype: torch.dtype) -> torch.Tensor:
    """A layer's unpadded input (B, in_channels, H, W), already scaled, as
    the layer takes it: ``dtype``, its zero channels appended, in
    :data:`MEMORY_FORMAT`."""
    x = x.to(dtype)
    if m.in_padded > x.shape[1]:
        x = F.pad(x, (0, 0, 0, 0, 0, m.in_padded - x.shape[1]))
    return x.contiguous(memory_format=MEMORY_FORMAT)


def layer_schedule(resolution: int = 1024, channel_base: int = 32768,
                   channel_max: int = 512, num_layers: int = 14, num_critical: int = 2,
                   first_cutoff: float = 2.0, first_stopband: float = 2 ** 2.1,
                   last_stopband_rel: float = 2 ** 0.3, margin_size: int = 10,
                   img_channels: int = 3) -> List[dict]:
    """One entry a layer (the input first, then L0 … L{num_layers}, the last
    ToRGB): ``cutoff``, ``stopband``, ``rate`` (sampling rate),
    ``half_width``, ``size`` and ``channels``; the geometric progression of
    cutoffs and stopbands of NVlabs' ``SynthesisNetwork``."""
    last_cutoff = resolution / 2
    last_stopband = last_cutoff * last_stopband_rel
    exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
    cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
    stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, resolution))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + margin_size * 2
    sizes[-2:] = resolution
    channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
    channels[-1] = img_channels
    return [dict(cutoff=float(cutoffs[i]), stopband=float(stopbands[i]), rate=int(rates[i]),
                 half_width=float(half_widths[i]), size=int(sizes[i]),
                 channels=int(channels[i])) for i in range(num_layers + 1)]


def design_lowpass_filter(numtaps: int, cutoff: float, width: float,
                          fs: float) -> Optional[Tuple[float, ...]]:
    """A separable Kaiser-window low-pass FIR (``scipy.signal.firwin`` with a
    transition ``width``, scaled to unit gain at DC) as a tuple of floats;
    None for one tap (the identity)."""
    if numtaps == 1:
        return None
    nyq = fs / 2
    atten = 2.285 * (numtaps - 1) * math.pi * (width / nyq) + 7.95
    if atten > 50:
        beta = 0.1102 * (atten - 8.7)
    elif atten > 21:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    else:
        beta = 0.0
    c = cutoff / nyq
    m = np.arange(numtaps) - (numtaps - 1) / 2
    h = c * np.sinc(c * m) * np.kaiser(numtaps, beta)
    h = h / h.sum()
    return tuple(float(v) for v in h.astype(np.float32))


class SynthesisInput(nn.Module):
    """Fourier features: ``freqs`` (C, 2) and ``phases`` (C,) fixed, an
    affine of w (4 outputs, bias (1, 0, 0, 0)) giving a rotation and a
    translation, and a 1×1 mix ``weight`` (C, C)."""

    def __init__(self, w_dim: int, channels: int, size: int, sampling_rate: float,
                 bandwidth: float):
        super().__init__()
        self.w_dim, self.channels, self.size = w_dim, channels, size
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        self.weight = nn.Parameter(torch.zeros(channels, channels))
        self.affine = EqualLinear(w_dim, 4)
        with torch.no_grad():
            self.affine.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))
        self.register_buffer("transform", torch.eye(3))
        self.register_buffer("freqs", torch.zeros(channels, 2))
        self.register_buffer("phases", torch.zeros(channels))


class SynthesisLayer(nn.Module):
    """One layer: ``affine`` (styles, bias 1), ``weight`` (out, in, k, k),
    ``bias``, ``magnitude_ema`` (the mean input square), and the K4 filters
    of its up/down sampling (``up_filter``/``down_filter`` buffers as NVlabs
    registers them; the layer computes with the same taps as floats).
    ``in_padded`` / ``out_padded``: the channel counts of its input and
    output activations with their zero channels (ToRGB's output unpadded)."""

    def __init__(self, w_dim: int, is_torgb: bool, in_channels: int, out_channels: int,
                 in_size: int, out_size: int, in_rate: int, out_rate: int, in_cutoff: float,
                 out_cutoff: float, in_half_width: float, out_half_width: float,
                 conv_kernel: int = 3, filter_size: int = 6, lrelu_upsampling: int = 2,
                 conv_clamp: Optional[float] = 256):
        super().__init__()
        self.is_torgb = is_torgb
        self.in_channels, self.out_channels = in_channels, out_channels
        self.in_padded = padded_channels(in_channels)
        self.out_padded = out_channels if is_torgb else padded_channels(out_channels)
        self.in_size, self.out_size = in_size, out_size
        self.in_rate, self.out_rate = in_rate, out_rate
        self.conv_kernel = 1 if is_torgb else conv_kernel
        self.conv_clamp = conv_clamp
        self.affine = EqualLinear(w_dim, in_channels, bias_init=1.0)
        k = self.conv_kernel
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("magnitude_ema", torch.ones([]))

        tmp_rate = max(in_rate, out_rate) * (1 if is_torgb else lrelu_upsampling)
        self.up = int(round(tmp_rate / in_rate))
        self.down = int(round(tmp_rate / out_rate))
        up_taps = filter_size * self.up if self.up > 1 and not is_torgb else 1
        down_taps = filter_size * self.down if self.down > 1 and not is_torgb else 1
        self.up_taps = design_lowpass_filter(up_taps, in_cutoff, in_half_width * 2, tmp_rate)
        self.down_taps = design_lowpass_filter(down_taps, out_cutoff, out_half_width * 2,
                                               tmp_rate)
        for name, taps in (("up_filter", self.up_taps), ("down_filter", self.down_taps)):
            self.register_buffer(name, None if taps is None else torch.tensor(taps))
        pad_total = (out_size - 1) * self.down + 1
        pad_total -= (in_size + k - 1) * self.up
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + self.up) // 2
        self.padding = (pad_lo, pad_total - pad_lo, pad_lo, pad_total - pad_lo)


class Generator(nn.Module):
    """StyleGAN3-T: ``mapping`` (``fc{i}``, ``w_avg``) and ``synthesis``
    (``input``, ``L{i}_{size}_{channels}``). Parameters start at zero (the
    Fourier input's affine bias (1, 0, 0, 0), the styles' biases 1, every
    ``magnitude_ema`` 1); ``weights/stylegan3.py`` has the seeded init."""

    def __init__(self, resolution: int = 1024, style_dim: int = 512, mapping_layers: int = 2,
                 channel_base: int = 32768, channel_max: int = 512, num_layers: int = 14,
                 num_critical: int = 2, first_cutoff: float = 2.0,
                 first_stopband: float = 2 ** 2.1, last_stopband_rel: float = 2 ** 0.3,
                 margin_size: int = 10, output_scale: float = 0.25, conv_kernel: int = 3,
                 filter_size: int = 6, lrelu_upsampling: int = 2,
                 conv_clamp: Optional[float] = 256):
        super().__init__()
        self.size, self.style_dim = resolution, style_dim
        self.n_latent = num_layers + 2
        self.output_scale = output_scale
        self.mapping = nn.Module()
        for i in range(mapping_layers):
            self.mapping.add_module(f"fc{i}", EqualLinear(style_dim, style_dim, lr_mul=0.01,
                                                          activation=True))
        self.mapping.register_buffer("w_avg", torch.zeros(style_dim))
        self.mapping_layers = mapping_layers
        self.schedule = layer_schedule(resolution, channel_base, channel_max, num_layers,
                                       num_critical, first_cutoff, first_stopband,
                                       last_stopband_rel, margin_size)
        sch = self.schedule
        self.synthesis = nn.Module()
        self.synthesis.input = SynthesisInput(style_dim, sch[0]["channels"], sch[0]["size"],
                                              sch[0]["rate"], sch[0]["cutoff"])
        self.layer_names: List[str] = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            layer = SynthesisLayer(
                style_dim, idx == num_layers, sch[prev]["channels"], sch[idx]["channels"],
                sch[prev]["size"], sch[idx]["size"], sch[prev]["rate"], sch[idx]["rate"],
                sch[prev]["cutoff"], sch[idx]["cutoff"], sch[prev]["half_width"],
                sch[idx]["half_width"], conv_kernel, filter_size, lrelu_upsampling,
                conv_clamp)
            name = f"L{idx}_{sch[idx]['size']}_{sch[idx]['channels']}"
            self.synthesis.add_module(name, layer)
            self.layer_names.append(name)

    def layers(self) -> List[SynthesisLayer]:
        return [getattr(self.synthesis, n) for n in self.layer_names]

    def forward(self, styles, **kwargs):
        return generator_forward(self, styles, **kwargs)


# ---------------------------------------------------------------------------
# Forward math
# ---------------------------------------------------------------------------

def fourier_features(m: SynthesisInput, w: torch.Tensor) -> torch.Tensor:
    """(B, 512) w → (B, C, size, size) float32 features (NVlabs'
    ``SynthesisInput.forward``)."""
    b = w.shape[0]
    t = equal_linear(w.float(), m.affine.weight, m.affine.bias)          # (B, 4)
    t = t / t[:, :2].norm(dim=1, keepdim=True)
    eye = torch.eye(3, device=w.device, dtype=torch.float32)
    m_r = eye.expand(b, 3, 3).clone()
    m_r[:, 0, 0], m_r[:, 0, 1], m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 0], -t[:, 1], t[:, 1], t[:, 0]
    m_t = eye.expand(b, 3, 3).clone()
    m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
    transforms = m_r @ m_t @ m.transform.float()[None]
    phases = m.phases.float()[None] + (m.freqs.float()[None] @ transforms[:, :2, 2:]).squeeze(2)
    freqs = m.freqs.float()[None] @ transforms[:, :2, :2]
    amplitudes = (1 - (freqs.norm(dim=2) - m.bandwidth)
                  / (m.sampling_rate / 2 - m.bandwidth)).clamp(0, 1)
    # the sampling grid of affine_grid(align_corners=False): pixel centres over
    # [-size / (2 rate), size / (2 rate)]
    s = m.size
    coords = ((torch.arange(s, device=w.device, dtype=torch.float32) * 2 + 1) / s - 1) \
        * (0.5 * s / m.sampling_rate)
    grid = torch.stack(torch.meshgrid(coords, coords, indexing="xy"), dim=-1)  # (s, s, 2): x, y
    x = torch.einsum("hwk,bck->bchw", grid, freqs) + phases[:, :, None, None]
    x = torch.sin(x * (2 * math.pi)) * amplitudes[:, :, None, None]
    weight = m.weight.float() / math.sqrt(m.channels)
    return torch.einsum("bihw,oi->bohw", x, weight)


class Modulation(NamedTuple):
    """What a layer's styles make of its conv: the input's scale a plane,
    s · gain (B, in_padded); the demodulation (B, out_padded), None on
    ToRGB; the conv weight (out_padded, in_padded, k, k), pre-normalised
    per output channel (ToRGB: as it is), in :data:`MEMORY_FORMAT`; zero in
    every pad channel."""
    in_scale: torch.Tensor
    demod: Optional[torch.Tensor]
    weight: torch.Tensor


def modulation(m: SynthesisLayer, w: torch.Tensor) -> Modulation:
    """StyleGAN3's modulated conv as the input/output-scaling identity,
    conv(x · s · gain, ŵ) · demod: ŵ the weight pre-normalised per output
    channel, s the styles pre-normalised over the batch, gain
    ``magnitude_ema.rsqrt()`` (ToRGB: no normalisation, no demod, styles
    times 1/sqrt(in)). The weight is made in :data:`MEMORY_FORMAT` with its
    pad channels, so that the convolution takes it as it is."""
    styles = equal_linear(w.float(), m.affine.weight, m.affine.bias)       # (B, in)
    weight = m.weight.float()
    gain = m.magnitude_ema.float().rsqrt()
    k = m.conv_kernel
    padded = torch.empty((m.out_padded, m.in_padded, k, k), device=weight.device,
                         memory_format=MEMORY_FORMAT)
    if padded.shape != weight.shape:
        padded.zero_()
    if m.is_torgb:
        styles = styles * (1.0 / math.sqrt(m.in_channels * k ** 2))
        padded[:, :m.in_channels] = weight
        return Modulation(_pad_channels(styles * gain, m.in_padded), None, padded)
    weight = torch.mul(weight, weight.square().mean(dim=(1, 2, 3), keepdim=True).rsqrt(),
                       out=padded[:m.out_channels, :m.in_channels])
    styles = styles * styles.square().mean().rsqrt()
    w2 = weight.square().sum(dim=(2, 3)).t()                                 # (in, out)
    demod = (styles.square() @ w2 + 1e-8).rsqrt()                           # (B, out)
    return Modulation(_pad_channels(styles * gain, m.in_padded),
                      _pad_channels(demod, m.out_padded), padded)


def layer_forward(m: SynthesisLayer, xs: torch.Tensor, mod: Modulation,
                  out_scale: Optional[torch.Tensor] = None,
                  output_scale: float = 1.0) -> torch.Tensor:
    """The conv (cuDNN, padded by k − 1) of ``xs``, the layer's input already
    scaled by ``mod.in_scale``, then K4 with the demodulation as its input
    scale and ``out_scale`` (the next layer's ``in_scale``) as its output
    scale; ToRGB's linear K4 call takes ``output_scale`` into its gain and
    clamp. ``xs`` has the layer's ``in_padded`` channels; the output its
    ``out_padded``, in xs's layout (channels-last in :func:`synthesis`)."""
    out = F.conv2d(xs, mod.weight.to(xs.dtype), padding=m.conv_kernel - 1)
    if m.is_torgb:
        gain, slope = output_scale, 1.0
        clamp = None if m.conv_clamp is None else m.conv_clamp * output_scale
    else:
        gain, slope, clamp = math.sqrt(2.0), 0.2, m.conv_clamp
    return filtered_lrelu(out, m.up_taps, m.down_taps, _pad_channels(m.bias, m.out_padded),
                          m.up, m.down, m.padding,
                          gain=gain, slope=slope, clamp=clamp, in_scale=mod.demod,
                          out_scale=out_scale)


def synthesis_layer(m: SynthesisLayer, x: torch.Tensor, w: torch.Tensor,
                    output_scale: float = 1.0) -> torch.Tensor:
    """One layer on its unscaled input ``x`` (B, in_channels, H, W):
    modulated conv → filtered leaky ReLU (K4); (B, out_channels, H', W')
    without the pad channels."""
    mod = modulation(m, w)
    xs = _to_layer_input(x * mod.in_scale[:, :m.in_channels, None, None].to(x.dtype), m, x.dtype)
    return layer_forward(m, xs, mod, output_scale=output_scale)[:, :m.out_channels]


def mapping(g: Generator, z: torch.Tensor) -> torch.Tensor:
    """Pixel norm and the ``fc`` layers (equalized, leaky ReLU through K2)."""
    x = pixel_norm(z)
    for i in range(g.mapping_layers):
        x = getattr(g.mapping, f"fc{i}")(x)
    return x


def mean_latent(g: Generator, rng: torch.Generator, n_latent: int = 4096) -> torch.Tensor:
    """Mean W over ``n_latent`` random z's (drawn from ``rng``, a CPU
    ``torch.Generator``, and mapped on g's device), for truncation."""
    z = torch.randn(n_latent, g.style_dim, generator=rng)
    return mapping(g, z.to(g.synthesis.input.weight.device)).mean(dim=0, keepdim=True)


def synthesis(g: Generator, latent: torch.Tensor, noise=None,
              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """W+ latent (B, n_latent, 512) → NHWC float32 image (contiguous: the
    activations are channels-last throughout). ``noise`` is taken for the
    interface and must be None: StyleGAN3 has no noise."""
    from ..utils.profiling import span      # utils imports the pipeline, which imports this
    if noise is not None:
        raise ValueError("StyleGAN3 has no noise inputs")
    sch = g.schedule
    ws = latent.float().unbind(dim=1)
    layers = g.layers()
    with span("sg3.layer", index=-1, rate=sch[0]["rate"], size=sch[0]["size"],
              channels=sch[0]["channels"]):
        nxt = modulation(layers[0], ws[1])
        x = fourier_features(g.synthesis.input, ws[0])
        x = _to_layer_input(x * nxt.in_scale[:, :x.shape[1], None, None], layers[0],
                            compute_dtype)
    for idx, m in enumerate(layers):
        mod = nxt
        with span("sg3.layer", index=idx, rate=m.out_rate, size=m.out_size,
                  channels=m.out_channels):
            last = idx == len(layers) - 1
            nxt = None if last else modulation(layers[idx + 1], ws[idx + 2])
            x = layer_forward(m, x, mod, None if last else nxt.in_scale,
                              g.output_scale if last else 1.0)
    return x.float().permute(0, 2, 3, 1)


def style_to_wplus(g: Generator, styles: Sequence[torch.Tensor],
                   inject_index: Optional[int] = None) -> torch.Tensor:
    """W (or a pair of W for mixing) → W+ (B, n_latent, 512)."""
    n_lat = g.n_latent
    if len(styles) < 2:
        s = styles[0]
        return s[:, None, :].repeat(1, n_lat, 1) if s.dim() < 3 else s
    if inject_index is None:
        raise ValueError("style mixing requires an explicit inject_index")
    l1 = styles[0][:, None, :].repeat(1, inject_index, 1)
    l2 = styles[1][:, None, :].repeat(1, n_lat - inject_index, 1)
    return torch.cat([l1, l2], dim=1)


def generator_forward(g: Generator, styles: Sequence[torch.Tensor], *,
                      input_is_latent: bool = False, truncation: float = 1.0,
                      truncation_latent: Optional[torch.Tensor] = None,
                      inject_index: Optional[int] = None, return_latents: bool = False,
                      noise=None, compute_dtype: torch.dtype = torch.float32):
    """``models/stylegan2.py::generator_forward`` for StyleGAN3: (NHWC image,
    W+ or None)."""
    if not input_is_latent:
        styles = [mapping(g, s) for s in styles]
    if truncation < 1:
        if truncation_latent is None:
            raise ValueError("truncation < 1 requires truncation_latent")
        styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]
    latent = style_to_wplus(g, styles, inject_index)
    image = synthesis(g, latent, noise, compute_dtype=compute_dtype)
    return image, (latent if return_latents else None)
