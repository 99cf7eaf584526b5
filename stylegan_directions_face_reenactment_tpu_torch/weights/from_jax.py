"""Weights for the port's modules: imported from the JAX package's
parameter pytrees, or made from a seed.

The ``*_from_jax`` functions take the JAX package's pytrees with numpy (or
any array) leaves and return the port's modules; this module never imports
JAX. Layout changes at the boundary:

  * conv HWIO (kh, kw, in, out) → OIHW (out, in, kh, kw), modulated convs
    included;
  * noise maps (1, R, R, 1) → (1, 1, R, R); the constant input
    (1, 4, 4, C) → (1, C, 4, 4);
  * batch norm {scale, offset, mean, var} → {weight, bias, running_mean,
    running_var}; linear (out, in) unchanged.

e4e's style heads ``convs[j]`` / ``biases[j]`` land on the reference's
``styles.N.convs.(2j)`` (LeakyReLUs sit between them); LPIPS's ``convs`` on
``net.layers.{0,3,6,8,10}`` and its ``lins`` (1, 1, C, 1) on
``lin.N.1.weight`` (1, C, 1, 1).

The last FAN module's ``bl``/``al``, which the JAX package zero-fills to
share one scan body, have no counterpart in the port and are not read.

The ``init_*`` functions give each module a seeded random init drawn from
the same distributions as the JAX package's ``init_*`` (not the same
numbers: the generators differ). Both build on the CPU and then move the
module to ``device`` (the CUDA card by default).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..losses.lpips import ALEX_LAYER_IDS, LPIPS
from ..models.deca.deca import DECA
from ..models.deca.flame import FLAME, synthetic_flame_params
from ..models.direction_matrix import DirectionMatrix
from ..models.e4e import Encoder4Editing
from ..models.face.fan import FAN
from ..models.face.s3fd import HEADS, NORMS, S3FD, TRUNK
from ..models.stylegan2 import (ConstantInput, EqualLinear, Generator,
                                ModulatedConv2d, NoiseBuffers)
from ..utils.device import DeviceLike, resolve_device

Params = Mapping[str, Any]
FLAME_VERTS, FLAME_FACES = 5023, 9976   # the real FLAME's sizes


def _np(a, perm=None) -> np.ndarray:
    a = np.asarray(a, dtype=np.float32)
    return np.transpose(a, perm) if perm is not None else a


def _load(module: nn.Module, arrays: Dict[str, np.ndarray]) -> None:
    """Copy ``arrays`` into ``module``'s state; every key and shape must
    match, and every parameter must be given."""
    sd = module.state_dict()
    for k, v in arrays.items():
        if k not in sd:
            raise KeyError(f"{type(module).__name__} has no entry {k!r}")
        if tuple(sd[k].shape) != v.shape:
            raise ValueError(f"{k}: shape {v.shape}, expected {tuple(sd[k].shape)}")
        sd[k] = torch.from_numpy(np.array(v, dtype=np.float32))
    missing = {n for n, _ in module.named_parameters()} - set(arrays)
    if missing:
        raise KeyError(f"no value for {sorted(missing)[:5]}")
    module.load_state_dict(sd)


# ---------------------------------------------------------------------------
# From the JAX package's pytrees
# ---------------------------------------------------------------------------

def generator_from_jax(params: Params, device: DeviceLike = None) -> Generator:
    meta = params["meta"]
    g = Generator(meta["size"], meta["style_dim"], len(params["style"]),
                  meta["channel_multiplier"])
    a: Dict[str, np.ndarray] = {"input.input": _np(params["input"], (0, 3, 1, 2))}
    for i, layer in enumerate(params["style"]):
        a[f"style.{i + 1}.weight"] = _np(layer["weight"])
        a[f"style.{i + 1}.bias"] = _np(layer["bias"])

    def modconv(prefix, p):
        a[f"{prefix}.weight"] = _np(p["weight"], (3, 2, 0, 1))
        a[f"{prefix}.modulation.weight"] = _np(p["mod"]["weight"])
        a[f"{prefix}.modulation.bias"] = _np(p["mod"]["bias"])

    def styled(prefix, p):
        modconv(f"{prefix}.conv", p["conv"])
        a[f"{prefix}.noise.weight"] = _np(p["noise_weight"]).reshape(1)
        a[f"{prefix}.activate.bias"] = _np(p["act_bias"])

    def rgb(prefix, p):
        modconv(f"{prefix}.conv", p["conv"])
        a[f"{prefix}.bias"] = _np(p["bias"]).reshape(1, 3, 1, 1)

    styled("conv1", params["conv1"])
    rgb("to_rgb1", params["to_rgb1"])
    for i, p in enumerate(params["convs"]):
        styled(f"convs.{i}", p)
    for i, p in enumerate(params["to_rgbs"]):
        rgb(f"to_rgbs.{i}", p)
    for i, n in enumerate(params["noises"]):
        a[f"noises.noise_{i}"] = _np(n, (0, 3, 1, 2))
    _load(g, a)
    return g.to(resolve_device(device))


def direction_matrix_from_jax(params: Params, device: DeviceLike = None) -> DirectionMatrix:
    meta = params["meta"]
    m = DirectionMatrix(meta["shift_dim"], meta["input_dim"], w_plus=meta["w_plus"],
                        num_layers=meta["num_layers"], bias="bias" in params)
    a = {"linear.weight": _np(params["weight"])}
    if "bias" in params:
        a["linear.bias"] = _np(params["bias"])
    _load(m, a)
    return m.to(resolve_device(device))


def _bn(a, prefix, p):
    a[f"{prefix}.weight"] = _np(p["scale"])
    a[f"{prefix}.bias"] = _np(p["offset"])
    a[f"{prefix}.running_mean"] = _np(p["mean"])
    a[f"{prefix}.running_var"] = _np(p["var"])


def flame_from_jax(params: Params, device: DeviceLike = None) -> FLAME:
    """The JAX FLAME pytree (``load_flame_params``' or
    ``synthetic_flame_params``' layout, as numpy arrays) → :class:`FLAME`."""
    return FLAME(params).to(resolve_device(device))


def deca_from_jax(params: Params, device: DeviceLike = None) -> DECA:
    """The JAX DECA bundle's ``e_flame`` encoder, and its ``flame`` model
    when the bundle has one → :class:`DECA`."""
    e = params["e_flame"]
    r = e["resnet"]
    hwio = (3, 2, 0, 1)
    a: Dict[str, np.ndarray] = {"E_flame.encoder.conv1.weight": _np(r["conv1"], hwio)}
    _bn(a, "E_flame.encoder.bn1", r["bn1"])
    for s, layer in enumerate(r["layers"]):
        for b, blk in enumerate(layer):
            pre = f"E_flame.encoder.layer{s + 1}.{b}"
            for i in (1, 2, 3):
                a[f"{pre}.conv{i}.weight"] = _np(blk[f"conv{i}"], hwio)
                _bn(a, f"{pre}.bn{i}", blk[f"bn{i}"])
            if "downsample" in blk:
                a[f"{pre}.downsample.0.weight"] = _np(blk["downsample"]["conv"], hwio)
                _bn(a, f"{pre}.downsample.1", blk["downsample"]["bn"])
    for idx, fc in ((0, "fc1"), (2, "fc2")):
        a[f"E_flame.layers.{idx}.weight"] = _np(e[fc]["weight"])
        a[f"E_flame.layers.{idx}.bias"] = _np(e[fc]["bias"])
    deca = DECA(FLAME(params["flame"]) if "flame" in params else None)
    _load(deca, a)
    return deca.to(resolve_device(device))


def s3fd_from_jax(params: Params, device: DeviceLike = None) -> S3FD:
    """The JAX S3FD pytree (``convert_s3fd``'s layout) → :class:`S3FD`."""
    a: Dict[str, np.ndarray] = {}
    for name in [t[0] for t in TRUNK] + [h[0] for h in HEADS]:
        a[f"{name}.weight"] = _np(params[name]["weight"], (3, 2, 0, 1))
        a[f"{name}.bias"] = _np(params[name]["bias"])
    for name, _, _ in NORMS:
        a[f"{name}.weight"] = _np(params[name])
    m = S3FD()
    _load(m, a)
    return m.to(resolve_device(device))


def _fan_block(a, prefix, p):
    for i in (1, 2, 3):
        _bn(a, f"{prefix}.bn{i}", p[f"bn{i}"])
        a[f"{prefix}.conv{i}.weight"] = _np(p[f"conv{i}"], (3, 2, 0, 1))
    if "downsample" in p:
        _bn(a, f"{prefix}.downsample.0", p["downsample"]["bn"])
        a[f"{prefix}.downsample.2.weight"] = _np(p["downsample"]["conv"], (3, 2, 0, 1))


def _conv_bias(a, prefix, p):
    a[f"{prefix}.weight"] = _np(p["weight"], (3, 2, 0, 1))
    a[f"{prefix}.bias"] = _np(p["bias"])


def fan_from_jax(params: Params, device: DeviceLike = None) -> FAN:
    """The JAX FAN pytree (``convert_fan``'s or ``init_fan``'s layout) →
    :class:`FAN`."""
    n = len(params["modules"])
    a: Dict[str, np.ndarray] = {}
    _conv_bias(a, "conv1", params["conv1"])
    _bn(a, "bn1", params["bn1"])
    for name in ("conv2", "conv3", "conv4"):
        _fan_block(a, name, params[name])
    for m, mod in enumerate(params["modules"]):
        for level, entry in mod["hg"]["levels"].items():
            for name, blk in entry.items():
                _fan_block(a, f"m{m}.{name}_{level}", blk)
        _fan_block(a, f"top_m_{m}", mod["top_m"])
        _conv_bias(a, f"conv_last{m}", mod["conv_last"])
        _bn(a, f"bn_end{m}", mod["bn_end"])
        _conv_bias(a, f"l{m}", mod["l"])
        if m < n - 1:
            _conv_bias(a, f"bl{m}", mod["bl"])
            _conv_bias(a, f"al{m}", mod["al"])
    fan = FAN(n)
    _load(fan, a)
    return fan.to(resolve_device(device))


def e4e_from_jax(params: Params, device: DeviceLike = None) -> Encoder4Editing:
    """The JAX e4e pytree (``convert_e4e_encoder``'s or
    ``init_e4e_encoder``'s layout) → :class:`Encoder4Editing`."""
    style_count = params["meta"]["style_count"]
    hwio = (3, 2, 0, 1)
    a: Dict[str, np.ndarray] = {"input_layer.0.weight": _np(params["input"]["conv"], hwio),
                                "input_layer.2.weight": _np(params["input"]["prelu"])}
    _bn(a, "input_layer.1", params["input"]["bn"])
    for i, blk in enumerate(params["body"]):
        pre = f"body.{i}"
        _bn(a, f"{pre}.res_layer.0", blk["bn0"])
        a[f"{pre}.res_layer.1.weight"] = _np(blk["conv1"], hwio)
        a[f"{pre}.res_layer.2.weight"] = _np(blk["prelu"])
        a[f"{pre}.res_layer.3.weight"] = _np(blk["conv2"], hwio)
        _bn(a, f"{pre}.res_layer.4", blk["bn2"])
        a[f"{pre}.res_layer.5.fc1.weight"] = _np(blk["se"]["fc1"], hwio)
        a[f"{pre}.res_layer.5.fc2.weight"] = _np(blk["se"]["fc2"], hwio)
        if "shortcut" in blk:
            a[f"{pre}.shortcut_layer.0.weight"] = _np(blk["shortcut"]["conv"], hwio)
            _bn(a, f"{pre}.shortcut_layer.1", blk["shortcut"]["bn"])
    for i, st in enumerate(params["styles"]):
        for j, (w, b) in enumerate(zip(st["convs"], st["biases"])):
            a[f"styles.{i}.convs.{2 * j}.weight"] = _np(w, hwio)
            a[f"styles.{i}.convs.{2 * j}.bias"] = _np(b)
        a[f"styles.{i}.linear.weight"] = _np(st["linear"]["weight"])
        a[f"styles.{i}.linear.bias"] = _np(st["linear"]["bias"])
    for name in ("latlayer1", "latlayer2"):
        _conv_bias(a, name, params[name])
    e = Encoder4Editing(2 ** ((style_count + 2) // 2))
    _load(e, a)
    return e.to(resolve_device(device))


def lpips_from_jax(params: Params, device: DeviceLike = None) -> LPIPS:
    """The JAX LPIPS pytree (``convert_lpips_alex``'s or ``init_lpips_alex``'s
    layout) → :class:`LPIPS`."""
    a: Dict[str, np.ndarray] = {}
    for idx, conv in zip(ALEX_LAYER_IDS, params["convs"]):
        _conv_bias(a, f"net.layers.{idx}", conv)
    for i, w in enumerate(params["lins"]):
        a[f"lin.{i}.1.weight"] = _np(w, (3, 2, 0, 1))
    lp = LPIPS()
    _load(lp, a)
    return lp.to(resolve_device(device))


# ---------------------------------------------------------------------------
# Seeded random init
# ---------------------------------------------------------------------------

def init_generator(seed: int = 0, size: int = 256, style_dim: int = 512,
                   n_mlp: int = 8, channel_multiplier: int = 2,
                   device: DeviceLike = None) -> Generator:
    """N(0, 1) conv/input/noise; equalized linears N(0, 1)/lr_mul with the
    biases of their constructors (modulation 1, others 0); zero noise
    weights and activation/RGB biases."""
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    g = Generator(size, style_dim, n_mlp, channel_multiplier)
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, EqualLinear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=rng) / m.lr_mul)
            elif isinstance(m, ModulatedConv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=rng))
            elif isinstance(m, ConstantInput):
                m.input.copy_(torch.randn(m.input.shape, generator=rng))
            elif isinstance(m, NoiseBuffers):
                for n in m.as_list():
                    n.copy_(torch.randn(n.shape, generator=rng))
    return g.to(dev)


def init_direction_matrix(seed: int = 0, shift_dim: int = 512, input_dim: int = 15,
                          *, w_plus: bool = True, num_layers: int = 8,
                          bias: bool = True, device: DeviceLike = None) -> DirectionMatrix:
    """A ~ N(0, 0.03), zero bias (the reference's ``normal`` init)."""
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    m = DirectionMatrix(shift_dim, input_dim, w_plus=w_plus,
                        num_layers=num_layers, bias=bias)
    with torch.no_grad():
        m.linear.weight.copy_(0.03 * torch.randn(m.linear.weight.shape, generator=rng))
    return m.to(dev)


def init_deca(seed: int = 0, device: DeviceLike = None) -> DECA:
    """ResNet convs N(0, sqrt(2 / (kh·kw·out))), batch norm at identity
    statistics, MLP weights U(±1/sqrt(in)) with zero biases; synthetic
    FLAME at the real model's 5023 vertices and 9976 faces, from a
    generator of its own seeded with ``seed``."""
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    deca = DECA(FLAME(synthetic_flame_params(torch.Generator().manual_seed(seed),
                                             n_verts=FLAME_VERTS, n_faces=FLAME_FACES)))
    with torch.no_grad():
        for m in deca.modules():
            if isinstance(m, nn.Conv2d):
                cout, _, kh, kw = m.weight.shape
                std = math.sqrt(2.0 / (kh * kw * cout))
                m.weight.copy_(torch.randn(m.weight.shape, generator=rng) * std)
            elif isinstance(m, nn.Linear):
                lim = 1.0 / math.sqrt(m.in_features)
                m.weight.copy_((torch.rand(m.weight.shape, generator=rng) * 2 - 1) * lim)
                m.bias.zero_()
    return deca.to(dev)


def init_s3fd(seed: int = 0, device: DeviceLike = None) -> S3FD:
    """Convs U(±1/sqrt(in·kh·kw)) with zero biases; L2Norm scales 10, 8, 5."""
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    m = S3FD()
    with torch.no_grad():
        for conv in m.modules():
            if isinstance(conv, nn.Conv2d):
                _, cin, kh, kw = conv.weight.shape
                lim = 1.0 / math.sqrt(cin * kh * kw)
                conv.weight.copy_((torch.rand(conv.weight.shape, generator=rng) * 2 - 1) * lim)
                conv.bias.zero_()
    return m.to(dev)


def init_fan(seed: int = 0, num_modules: int = 4, device: DeviceLike = None) -> FAN:
    """Convs N(0, sqrt(2 / (kh·kw·out))) with zero biases, batch norm at
    identity statistics (the JAX package's ``init_fan``)."""
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    fan = FAN(num_modules)
    with torch.no_grad():
        for m in fan.modules():
            if isinstance(m, nn.Conv2d):
                cout, _, kh, kw = m.weight.shape
                m.weight.copy_(torch.randn(m.weight.shape, generator=rng)
                               * math.sqrt(2.0 / (kh * kw * cout)))
                if m.bias is not None:
                    m.bias.zero_()
    return fan.to(dev)


def init_e4e(seed: int = 0, image_resolution: int = 256,
             device: DeviceLike = None) -> Encoder4Editing:
    """The JAX package's ``init_e4e_encoder`` distributions: every conv
    (stem, body, SE gates, shortcuts, style heads, lateral layers) He-uniform
    U(±sqrt(6 / (in·kh·kw))) with zero biases, batch norm at identity
    statistics, PReLU slopes 0.25, equalized linears N(0, 1) with zero
    biases."""
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    e = Encoder4Editing(image_resolution)
    with torch.no_grad():
        for m in e.modules():
            if isinstance(m, nn.Conv2d):
                _, cin, kh, kw = m.weight.shape
                lim = math.sqrt(6.0 / (cin * kh * kw))
                m.weight.copy_((torch.rand(m.weight.shape, generator=rng) * 2 - 1) * lim)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, EqualLinear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=rng))
    return e.to(dev)


def init_lpips(seed: int = 0, device: DeviceLike = None) -> LPIPS:
    """The JAX package's ``init_lpips_alex`` distributions: AlexNet convs
    U(±1/sqrt(in·k·k)) with zero biases, linear heads U(0, 2/C)."""
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    lp = LPIPS()
    with torch.no_grad():
        for idx in ALEX_LAYER_IDS:
            conv = lp.net.layers[idx]
            _, cin, k, _ = conv.weight.shape
            lim = 1.0 / math.sqrt(cin * k * k)
            conv.weight.copy_((torch.rand(conv.weight.shape, generator=rng) * 2 - 1) * lim)
            conv.bias.zero_()
        for lin in lp.lin:
            w = lin[1].weight
            w.copy_(torch.rand(w.shape, generator=rng) * (2.0 / w.shape[1]))
    return lp.to(dev)
