"""Seeded weights for the port's StyleGAN3-T generator
(``models/stylegan3.py``), under NVlabs' ``G_ema`` state-dict names.

No StyleGAN3 checkpoint is in the repository, so :func:`init_stylegan3`
draws one from a seed with NVlabs' init distributions, and sets what a
trained model holds that an untrained one does not:

* the Fourier input's affine, zero at NVlabs' init, is drawn N(0, 0.1²), so
  that w[0] turns and shifts the features a little, as a trained model's
  does;
* every layer's ``magnitude_ema`` is its input's mean square over a seeded
  batch of w's (:func:`calibrate_magnitude_ema`), as training leaves it, so
  that random weights keep the scale trained ones have.

A published ``G_ema`` state dict loads over it with ``load_state_dict``.
"""

from __future__ import annotations

import torch

from ..models.stylegan2 import EqualLinear
from ..models.stylegan3 import Generator, fourier_features, mapping, synthesis_layer
from ..utils.device import DeviceLike, resolve_device

INPUT_AFFINE_STD = 0.1


@torch.no_grad()
def draw_fourier_input(g: Generator, rng: torch.Generator) -> None:
    """NVlabs' draw of the Fourier features: frequencies from a 2-D
    distribution within the band, phases uniform in [-0.5, 0.5), the 1×1 mix
    N(0, 1), the affine N(0, 0.1²) with bias (1, 0, 0, 0)."""
    m = g.synthesis.input
    freqs = torch.randn(m.channels, 2, generator=rng)
    radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
    freqs = freqs / (radii * radii.square().exp().pow(0.25)) * m.bandwidth
    m.freqs.copy_(freqs)
    m.phases.copy_(torch.rand(m.channels, generator=rng) - 0.5)
    m.weight.copy_(torch.randn(m.weight.shape, generator=rng))
    m.affine.weight.copy_(torch.randn(m.affine.weight.shape, generator=rng) * INPUT_AFFINE_STD)


@torch.no_grad()
def calibrate_magnitude_ema(g: Generator, ws: torch.Tensor) -> None:
    """Set each layer's ``magnitude_ema`` to the mean square of its input
    over the W+ batch ``ws`` (B, n_latent, 512), layer by layer in float32."""
    w = ws.float().unbind(dim=1)
    x = fourier_features(g.synthesis.input, w[0])
    for m, wi in zip(g.layers(), w[1:]):
        m.magnitude_ema.copy_(x.square().mean())
        x = synthesis_layer(m, x, wi)


def init_stylegan3(seed: int = 0, device: DeviceLike = None, calibration_batch: int = 8,
                   **kwargs) -> Generator:
    """A StyleGAN3-T generator (``kwargs`` as :class:`Generator` takes them)
    with seeded weights: equalized linears N(0, 1)/lr_mul with their
    constructors' biases, convolutions N(0, 1), zero layer biases, the
    Fourier input as :func:`draw_fourier_input`, and ``magnitude_ema`` from
    ``calibration_batch`` seeded z's through the mapping."""
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    g = Generator(**kwargs)
    with torch.no_grad():
        for name, m in g.named_modules():
            if isinstance(m, EqualLinear) and name != "synthesis.input.affine":
                m.weight.copy_(torch.randn(m.weight.shape, generator=rng) / m.lr_mul)
        for m in g.layers():
            m.weight.copy_(torch.randn(m.weight.shape, generator=rng))
        draw_fourier_input(g, rng)
        z = torch.randn(calibration_batch, g.style_dim, generator=rng)
    g = g.to(dev)
    with torch.no_grad():
        w = mapping(g, z.to(dev))
        calibrate_magnitude_ema(g, w[:, None].repeat(1, g.n_latent, 1))
    return g
