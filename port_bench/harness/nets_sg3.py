"""The StyleGAN3-T generator of a configuration, its weights drawn on the
device from the seed: built from the plain reference's classes
(``reference/model/models/stylegan3.py``), filled with NVlabs' init
distributions and the configuration's ``assumed`` edits, and loaded into the
port's generator (``models/stylegan3.py``) of the same state-dict layout.
The face nets and A come from ``harness/nets.py``, as in the other cells;
the generator takes the sub-seed ``nets.py`` gives its ``g``."""

from __future__ import annotations

import importlib
from typing import Dict

import torch
import torch.nn as nn

from . import nets

MAGNITUDE_BATCH = 4      # seeded w's that set each layer's magnitude_ema
INPUT_AFFINE_STD = 0.1   # assumed: the Fourier input's affine, zero at NVlabs' init


def generator_kwargs(cfg: Dict) -> Dict:
    gen = dict(cfg["generator"])
    for key in ("arch", "n_latent", "layers"):
        gen.pop(key, None)
    return gen


def construct(root: str, cfg: Dict) -> nn.Module:
    """The generator of ``cfg`` from package ``root`` (the reference's or the
    port's ``models.stylegan3``), on the current default device."""
    return importlib.import_module(f"{root}.models.stylegan3").Generator(**generator_kwargs(cfg))


def _leaves(g: nn.Module):
    """The normal and uniform draws: equalized linears N(0, 1)/lr, the
    Fourier mix N(0, 1), its affine N(0, 0.1²), the convolutions N(0, 1),
    raw frequencies N(0, 1) and phases U[-0.5, 0.5)."""
    inp = g.synthesis.input
    leaves = []
    for i in range(g.mapping.num_layers):
        fc = getattr(g.mapping, f"fc{i}")
        leaves.append((fc.weight, "n", 1.0 / fc.bias_gain, 0.0))
    leaves += [(inp.freqs, "n", 1.0, 0.0), (inp.phases, "u", 1.0, -0.5),
               (inp.weight, "n", 1.0, 0.0), (inp.affine.weight, "n", INPUT_AFFINE_STD, 0.0)]
    for name in g.synthesis.layer_names:
        layer = getattr(g.synthesis, name)
        leaves += [(layer.affine.weight, "n", 1.0, 0.0), (layer.weight, "n", 1.0, 0.0)]
    return leaves


@torch.no_grad()
def _calibrate(g: nn.Module, gen: torch.Generator) -> None:
    """Each layer's magnitude_ema := its input's mean square over
    MAGNITUDE_BATCH seeded w's, layer after layer, a frame at a time."""
    from reference import plain_float32
    z = torch.randn(MAGNITUDE_BATCH, g.style_dim, generator=gen, device=gen.device)
    with plain_float32():
        w = g.mapping(z)
        xs = [g.synthesis.input(w[i:i + 1]) for i in range(w.shape[0])]
        for name in g.synthesis.layer_names:
            layer = getattr(g.synthesis, name)
            layer.magnitude_ema.copy_(torch.stack([x.square().mean() for x in xs]).mean())
            xs = [layer(x, w[i:i + 1]) for i, x in enumerate(xs)]


def reference_g(cfg: Dict, seed: int, device: torch.device) -> nn.Module:
    """The reference's generator, its weights drawn from ``seed``."""
    with torch.device(device):
        g = construct(nets.REF, cfg).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * len(nets.NETS) + nets.NETS.index("g"))
    nets.fill(_leaves(g), gen)
    with torch.no_grad():
        inp = g.synthesis.input
        radii = inp.freqs.square().sum(dim=1, keepdim=True).sqrt()
        inp.freqs.copy_(inp.freqs / (radii * radii.square().exp().pow(0.25)) * inp.bandwidth)
    _calibrate(g, gen)
    return g.eval()


def port_g(port: str, cfg: Dict, seed: int, device: torch.device) -> nn.Module:
    """The port's generator, holding the reference's weights."""
    ref = reference_g(cfg, seed, device)
    with torch.device(device):
        g = construct(port, cfg).to(device)
    g.load_state_dict(ref.state_dict(), strict=True)
    return g.eval()
