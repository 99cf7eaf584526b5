"""Seeded weights, made on the device in a few large draws.

The nets are built from the frozen reference's classes
(``reference/model``), filled from the seed, and their state dicts are
loaded into the port's modules of the same layout. The reference builds
its own copy again from the same seed after the window, so it takes no
tensor the program holds. The distributions are the port's seeded inits
(``weights/from_jax.py``), plus the configuration's ``assumed`` edits that
let random weights take the path trained weights take.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, Iterable, List, Tuple

import torch
import torch.nn as nn

REF = "reference.model"
NETS = ("g", "a", "deca", "sfd", "fan")   # fixed order of sub-seeds

Leaf = Tuple[torch.Tensor, str, float, float]   # tensor, "n" or "u", scale, offset


def _mods(root: str):
    imp = importlib.import_module
    return {"sg": imp(f"{root}.models.stylegan2"), "dm": imp(f"{root}.models.direction_matrix"),
            "deca": imp(f"{root}.models.deca.deca"), "s3fd": imp(f"{root}.models.face.s3fd"),
            "fan": imp(f"{root}.models.face.fan")}


def construct(root: str, cfg: Dict, names: Iterable[str]) -> Dict[str, nn.Module]:
    """The modules ``names`` of configuration ``cfg`` from package ``root``,
    on the current default device."""
    m, gen = _mods(root), cfg["generator"]
    makers = {
        "g": lambda: m["sg"].Generator(gen["resolution"], gen["style_dim"], gen["n_mlp"],
                                       gen["channel_multiplier"]),
        "a": lambda: m["dm"].DirectionMatrix(gen["style_dim"], cfg["directions"]["learned_directions"],
                                             w_plus=True, num_layers=cfg["directions"]["num_layers_shift"]),
        "deca": lambda: m["deca"].DECA(None),
        "sfd": lambda: m["s3fd"].S3FD(),
        "fan": lambda: m["fan"].FAN(cfg["fan"]["num_modules"]),
    }
    return {n: makers[n]() for n in names}


def _conv_he_normal(c: nn.Conv2d) -> List[Leaf]:
    cout, _, kh, kw = c.weight.shape
    return [(c.weight, "n", math.sqrt(2.0 / (kh * kw * cout)), 0.0)]


def _sym(t: torch.Tensor, lim: float) -> Leaf:
    return (t, "u", 2.0 * lim, -lim)


def _plan(name: str, net: nn.Module, cfg: Dict) -> List[Leaf]:
    """The leaves of ``net`` that the seed draws, and their distributions;
    every other leaf keeps its constructor's value (zeros, ones, constants)."""
    leaves: List[Leaf] = []
    for mod in net.modules():
        kind = type(mod).__name__
        if name == "g":
            if kind == "EqualLinear":
                leaves.append((mod.weight, "n", 1.0 / mod.lr_mul, 0.0))
            elif kind == "ModulatedConv2d":
                leaves.append((mod.weight, "n", 1.0, 0.0))
            elif kind == "ConstantInput":
                leaves.append((mod.input, "n", 1.0, 0.0))
            elif kind == "NoiseBuffers":
                leaves += [(t, "n", 1.0, 0.0) for t in mod.as_list()]
        elif name == "a" and kind == "Linear":
            leaves.append((mod.weight, "n", 0.03, 0.0))
            if mod.bias is not None:
                leaves.append((mod.bias, "n", 0.0, 0.0))
        elif name in ("deca", "fan") and kind == "Conv2d":
            leaves += _conv_he_normal(mod)
            if mod.bias is not None:
                leaves.append((mod.bias, "n", 0.0, 0.0))
        elif name == "deca" and kind == "Linear":
            leaves += [_sym(mod.weight, 1.0 / math.sqrt(mod.in_features)),
                       (mod.bias, "n", 0.0, 0.0)]
        elif name == "fan" and kind == "BatchNorm2d":
            # assumed: random statistics, so that the seeded FAN's heatmaps
            # peak apart and the landmarks' box has a size
            leaves += [(mod.weight, "n", 0.1, 1.0), (mod.bias, "n", 0.1, 0.0),
                       (mod.running_mean, "n", 0.1, 0.0), (mod.running_var, "u", 1.0, 0.5)]
        elif name == "sfd" and kind == "Conv2d":
            _, cin, kh, kw = mod.weight.shape
            leaves += [_sym(mod.weight, 1.0 / math.sqrt(cin * kh * kw)),
                       (mod.bias, "n", 0.0, 0.0)]
    return leaves


@torch.no_grad()
def fill(leaves: List[Leaf], gen: torch.Generator) -> None:
    """One draw for the normal leaves and one for the uniform ones."""
    for kind, draw in (("n", torch.randn), ("u", torch.rand)):
        group = [lf for lf in leaves if lf[1] == kind]
        total = sum(t.numel() for t, *_ in group)
        if not total:
            continue
        flat = draw(total, generator=gen, device=gen.device)
        off = 0
        for t, _, scale, shift in group:
            n = t.numel()
            t.copy_((flat[off:off + n] * scale + shift).view_as(t))
            off += n


@torch.no_grad()
def _assumed(name: str, net: nn.Module) -> None:
    if name == "sfd":
        # S3FD's first convolution reads one colour direction, orthogonal to
        # the "fa" convention's mean (104, 117, 123), behind a dead zone of
        # 8: black is no content in either input convention, so the DECA
        # alignment's face, too, lies on the textured patch. Its weights
        # carry few bits, so black sums to 0 in bf16 and TF32 as well.
        conv1 = net.conv1_1
        colour = torch.tensor([6.0, -19.0, 13.0], device=conv1.weight.device) / 16.0
        taps = torch.round(conv1.weight[:, 0] * 16.0) / 16.0
        conv1.weight.copy_(taps[:, None] * colour[None, :, None, None])
        conv1.bias.fill_(-8.0)
        # S3FD's stride-4 face logit := the sum of the L2-normed conv3_3
        # features in its 3x3 window less 10: the kept face lies on content
        conv = net.conv3_3_norm_mbox_conf
        conv.weight.zero_()
        conv.bias.zero_()
        conv.weight[3] = 1.0
        conv.bias[3] = -10.0


def reference_nets(cfg: Dict, names: Iterable[str], seed: int,
                   device: torch.device) -> Dict[str, nn.Module]:
    """The reference's nets ``names``, their weights drawn from ``seed``."""
    torch.manual_seed(seed)          # the constructors' own draws, overwritten or unused
    with torch.device(device):
        nets = construct(REF, cfg, names)
    for name, net in nets.items():
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * len(NETS) + NETS.index(name))
        fill(_plan(name, net, cfg), gen)
        _assumed(name, net)
        net.eval()
    return nets


def port_nets(port: str, cfg: Dict, names: Iterable[str], seed: int,
              device: torch.device) -> Dict[str, nn.Module]:
    """The port's modules of the same layout, holding the same weights."""
    names = list(names)
    ref = reference_nets(cfg, names, seed, device)
    with torch.device(device):
        nets = construct(port, cfg, names)
    for name in names:
        nets[name].load_state_dict(ref[name].state_dict(), strict=True)
        nets[name].eval()
    del ref
    return nets
