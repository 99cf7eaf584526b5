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
from ..models.deca.deca import DECA, DetailGenerator
from ..models.deca.flame import FLAME, FLAMETex, synthetic_flame_params
from ..models.direction_matrix import DirectionMatrix
from ..models.e4e import (BackboneEncoderUsingLastLayerIntoW, Encoder4Editing,
                          GradualStyleEncoder)
from ..models.face.fan import FAN, ResNetDepth
from ..models.face.s3fd import HEADS, NORMS, S3FD, TRUNK
from ..models.irse import Backbone
from ..models.stylegan2 import (ConstantInput, Discriminator, EqualConv2d,
                                EqualLinear, Generator, ModulatedConv2d, NoiseBuffers,
                                WPlusEncoder)
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


def _resnet_encoder(a, prefix, e):
    r = e["resnet"]
    hwio = (3, 2, 0, 1)
    a[f"{prefix}.encoder.conv1.weight"] = _np(r["conv1"], hwio)
    _bn(a, f"{prefix}.encoder.bn1", r["bn1"])
    for s, layer in enumerate(r["layers"]):
        for b, blk in enumerate(layer):
            pre = f"{prefix}.encoder.layer{s + 1}.{b}"
            for i in (1, 2, 3):
                a[f"{pre}.conv{i}.weight"] = _np(blk[f"conv{i}"], hwio)
                _bn(a, f"{pre}.bn{i}", blk[f"bn{i}"])
            if "downsample" in blk:
                a[f"{pre}.downsample.0.weight"] = _np(blk["downsample"]["conv"], hwio)
                _bn(a, f"{pre}.downsample.1", blk["downsample"]["bn"])
    for idx, fc in ((0, "fc1"), (2, "fc2")):
        a[f"{prefix}.layers.{idx}.weight"] = _np(e[fc]["weight"])
        a[f"{prefix}.layers.{idx}.bias"] = _np(e[fc]["bias"])


def detail_l1_from_jax(w: np.ndarray) -> np.ndarray:
    """The JAX decoder's linear rows, which it reads as (8, 8, 128)
    channel-last, reordered to the port's (128, 8, 8) channel-major view,
    the reference's (``decoders.py``: ``out.view(B, 128, 8, 8)``). Leading
    axis: the 8192 outputs."""
    w = np.asarray(w, np.float32)
    return w.reshape((8, 8, 128) + w.shape[1:]).transpose(
        (2, 0, 1) + tuple(range(3, w.ndim + 2))).reshape(w.shape)


def _detail_generator(a, d, prefix="D_detail."):
    a[f"{prefix}l1.0.weight"] = detail_l1_from_jax(d["l1"]["weight"])
    a[f"{prefix}l1.0.bias"] = detail_l1_from_jax(d["l1"]["bias"])
    _bn(a, f"{prefix}conv_blocks.0", d["bn0"])
    for i, (conv, bn) in enumerate(zip(d["convs"], d["bns"])):
        a[f"{prefix}conv_blocks.{2 + 4 * i}.weight"] = _np(conv["weight"], (3, 2, 0, 1))
        a[f"{prefix}conv_blocks.{2 + 4 * i}.bias"] = _np(conv["bias"])
        _bn(a, f"{prefix}conv_blocks.{3 + 4 * i}", bn)
    a[f"{prefix}conv_blocks.21.weight"] = _np(d["conv_out"]["weight"], (3, 2, 0, 1))
    a[f"{prefix}conv_blocks.21.bias"] = _np(d["conv_out"]["bias"])


def detail_generator_from_jax(params: Params, device: DeviceLike = None) -> DetailGenerator:
    """The JAX displacement decoder (``init_detail_generator``'s layout) →
    :class:`DetailGenerator`, its linear rows reordered by
    :func:`detail_l1_from_jax`."""
    a: Dict[str, np.ndarray] = {}
    _detail_generator(a, params, prefix="")
    m = DetailGenerator(latent_dim=np.shape(params["l1"]["weight"])[1],
                        out_channels=np.shape(params["conv_out"]["weight"])[3])
    _load(m, a)
    return m.to(resolve_device(device))


def deca_from_jax(params: Params, device: DeviceLike = None) -> DECA:
    """The JAX DECA bundle → :class:`DECA`: ``e_flame``; ``e_detail`` and
    ``d_detail`` when the bundle has both (the decoder's linear rows
    reordered by :func:`detail_l1_from_jax`, so the two compute the same
    map); its ``flame`` model and ``flametex`` texture space when it has
    them."""
    a: Dict[str, np.ndarray] = {}
    _resnet_encoder(a, "E_flame", params["e_flame"])
    with_detail = "e_detail" in params and "d_detail" in params
    if with_detail:
        _resnet_encoder(a, "E_detail", params["e_detail"])
        _detail_generator(a, params["d_detail"])
    tex = params.get("flametex")
    deca = DECA(FLAME(params["flame"]) if "flame" in params else None, with_detail=with_detail,
                flametex=FLAMETex(tex["texture_mean"], tex["texture_basis"]) if tex else None)
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


def _irse_trunk(params: Params) -> Dict[str, np.ndarray]:
    """The IR-SE stem and body of a JAX pytree (``input``, ``body``) under
    the reference's keys (``input_layer.N``, ``body.N.*``)."""
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
    return a


def e4e_from_jax(params: Params, device: DeviceLike = None,
                 cls=Encoder4Editing) -> Encoder4Editing:
    """The JAX e4e pytree (``convert_e4e_encoder``'s or
    ``init_e4e_encoder``'s layout) → :class:`Encoder4Editing` (or ``cls``,
    a module of its layout)."""
    style_count = params["meta"]["style_count"]
    hwio = (3, 2, 0, 1)
    a = _irse_trunk(params)
    for i, st in enumerate(params["styles"]):
        for j, (w, b) in enumerate(zip(st["convs"], st["biases"])):
            a[f"styles.{i}.convs.{2 * j}.weight"] = _np(w, hwio)
            a[f"styles.{i}.convs.{2 * j}.bias"] = _np(b)
        a[f"styles.{i}.linear.weight"] = _np(st["linear"]["weight"])
        a[f"styles.{i}.linear.bias"] = _np(st["linear"]["bias"])
    for name in ("latlayer1", "latlayer2"):
        _conv_bias(a, name, params[name])
    e = cls(2 ** ((style_count + 2) // 2))
    _load(e, a)
    return e.to(resolve_device(device))


def gradual_style_encoder_from_jax(params: Params,
                                   device: DeviceLike = None) -> GradualStyleEncoder:
    """The JAX ``init_gradual_style_encoder`` pytree (e4e's layout) →
    :class:`GradualStyleEncoder`."""
    return e4e_from_jax(params, device, cls=GradualStyleEncoder)


def _equal_linear(a, prefix, p, in_perm=None):
    w = _np(p["weight"])
    if in_perm is not None:       # the JAX flatten's order → the port's (NCHW)
        w = w.reshape((w.shape[0],) + in_perm[0]).transpose(in_perm[1]).reshape(w.shape)
    a[f"{prefix}.weight"] = w
    a[f"{prefix}.bias"] = _np(p["bias"])


def backbone_encoder_into_w_from_jax(
        params: Params, device: DeviceLike = None) -> BackboneEncoderUsingLastLayerIntoW:
    """The JAX ``init_backbone_encoder_into_w`` pytree →
    :class:`BackboneEncoderUsingLastLayerIntoW`."""
    a = _irse_trunk(params)
    _equal_linear(a, "linear", params["linear"])
    e = BackboneEncoderUsingLastLayerIntoW()
    _load(e, a)
    return e.to(resolve_device(device))


def _conv_layer(a, prefix, p):
    """A JAX ``conv_layer`` (HWIO ``conv``, ``act_bias``) under the
    reference's ConvLayer keys (the blur's taps are the module's own)."""
    i = 1 if p["_meta"]["downsample"] else 0
    a[f"{prefix}.{i}.weight"] = _np(p["conv"]["weight"], (3, 2, 0, 1))
    if "bias" in p["conv"]:
        a[f"{prefix}.{i}.bias"] = _np(p["conv"]["bias"])
    if "act_bias" in p:
        a[f"{prefix}.{i + 1}.bias"] = _np(p["act_bias"])


def _res_trunk(a, blocks):
    _conv_layer(a, "convs.0", blocks[0])
    for n, blk in enumerate(blocks[1:], 1):
        for name in ("conv1", "conv2", "skip"):
            _conv_layer(a, f"convs.{n}.{name}", blk[name])


def discriminator_from_jax(params: Params, channel_multiplier: int = 2,
                           device: DeviceLike = None) -> Discriminator:
    """The JAX ``init_discriminator`` pytree → :class:`Discriminator`.
    ``final_linear.0`` reads the JAX package's NHWC flatten (h, w, c); its
    input rows are reordered to the reference's NCHW flatten."""
    size = params["meta"]["size"]
    a: Dict[str, np.ndarray] = {}
    _res_trunk(a, params["blocks"])
    _conv_layer(a, "final_conv", params["final_conv"])
    c = params["final_conv"]["act_bias"].shape[0]
    _equal_linear(a, "final_linear.0", params["final_linear"][0],
                  in_perm=((4, 4, c), (0, 3, 1, 2)))
    _equal_linear(a, "final_linear.1", params["final_linear"][1])
    d = Discriminator(size, channel_multiplier)
    _load(d, a)
    return d.to(resolve_device(device))


def wplus_encoder_from_jax(params: Params, device: DeviceLike = None) -> WPlusEncoder:
    """The JAX ``init_wplus_encoder`` pytree → :class:`WPlusEncoder`."""
    n = len(params["blocks"])
    a: Dict[str, np.ndarray] = {}
    _res_trunk(a, params["blocks"])
    a[f"convs.{n}.weight"] = _np(params["final"]["weight"], (3, 2, 0, 1))
    e = WPlusEncoder(2 ** (n + 1), params["meta"]["w_dim"])
    _load(e, a)
    return e.to(resolve_device(device))


def resnet_depth_from_jax(params: Params, device: DeviceLike = None) -> ResNetDepth:
    """The JAX ``init_resnet_depth`` pytree → :class:`ResNetDepth`."""
    hwio = (3, 2, 0, 1)
    a: Dict[str, np.ndarray] = {"conv1.weight": _np(params["conv1"], hwio)}
    _bn(a, "bn1", params["bn1"])
    for s_i, layer in enumerate(params["layers"]):
        for b, blk in enumerate(layer):
            pre = f"layer{s_i + 1}.{b}"
            for i in (1, 2, 3):
                a[f"{pre}.conv{i}.weight"] = _np(blk[f"conv{i}"], hwio)
                _bn(a, f"{pre}.bn{i}", blk[f"bn{i}"])
            if "downsample" in blk:
                a[f"{pre}.downsample.0.weight"] = _np(blk["downsample"]["conv"], hwio)
                _bn(a, f"{pre}.downsample.1", blk["downsample"]["bn"])
    a["fc.weight"], a["fc.bias"] = _np(params["fc"]["weight"]), _np(params["fc"]["bias"])
    m = ResNetDepth(tuple(len(layer) for layer in params["layers"]),
                    params["fc"]["weight"].shape[0])
    _load(m, a)
    return m.to(resolve_device(device))


def id_backbone_from_jax(params: Params, device: DeviceLike = None) -> Backbone:
    """The JAX ArcFace pytree (``convert_irse_backbone``'s or
    ``init_backbone``'s layout) → :class:`Backbone`. The last norm has no
    affine terms (the JAX pytree's scale 1 and offset 0 are not read)."""
    a = _irse_trunk(params)
    _bn(a, "output_layer.0", params["out_bn2d"])
    a["output_layer.3.weight"] = _np(params["out_linear"]["weight"])
    a["output_layer.3.bias"] = _np(params["out_linear"]["bias"])
    a["output_layer.4.running_mean"] = _np(params["out_bn1d"]["mean"])
    a["output_layer.4.running_var"] = _np(params["out_bn1d"]["var"])
    m = Backbone(params["meta"]["input_size"])
    _load(m, a)
    return m.to(resolve_device(device))


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


def init_deca(seed: int = 0, device: DeviceLike = None, with_detail: bool = False) -> DECA:
    """ResNet convs N(0, sqrt(2 / (kh·kw·out))), batch norm at identity
    statistics, MLP weights U(±1/sqrt(in)) with zero biases; synthetic
    FLAME at the real model's 5023 vertices and 9976 faces, from a
    generator of its own seeded with ``seed``. ``with_detail`` adds
    ``E_detail`` and ``D_detail`` (the decoder's convs U(±1/sqrt(in·9))
    with zero biases), drawn after ``E_flame``, whose weights it leaves as
    they are without it."""
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    deca = DECA(FLAME(synthetic_flame_params(torch.Generator().manual_seed(seed),
                                             n_verts=FLAME_VERTS, n_faces=FLAME_FACES)),
                with_detail=with_detail)
    decoder = set(deca.D_detail.modules()) if with_detail else set()
    with torch.no_grad():
        for m in deca.modules():
            if isinstance(m, nn.Conv2d) and m in decoder:
                lim = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.copy_((torch.rand(m.weight.shape, generator=rng) * 2 - 1) * lim)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
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


def init_discriminator(seed: int = 0, size: int = 256, channel_multiplier: int = 2,
                       device: DeviceLike = None) -> Discriminator:
    """The JAX package's ``init_discriminator`` distributions: equalized
    convs and linears N(0, 1), zero biases."""
    return _init_equalized(Discriminator(size, channel_multiplier), seed, device)


def init_wplus_encoder(seed: int = 0, size: int = 256, w_dim: int = 512,
                       device: DeviceLike = None) -> WPlusEncoder:
    """The JAX package's ``init_wplus_encoder`` distributions (N(0, 1)
    equalized convs, zero biases)."""
    return _init_equalized(WPlusEncoder(size, w_dim), seed, device)


def _init_equalized(module: nn.Module, seed: int, device: DeviceLike):
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (EqualConv2d, EqualLinear)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=rng))
    return module.to(dev)


def init_resnet_depth(seed: int = 0, layers=(3, 8, 36, 3), num_classes: int = 68,
                      device: DeviceLike = None) -> ResNetDepth:
    """The JAX package's ``init_resnet_depth`` distributions: convs N(0,
    sqrt(2 / (kh·kw·out))), batch norm at identity statistics, ``fc``
    U(±1/sqrt(2048)) with a zero bias."""
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    m = ResNetDepth(layers, num_classes)
    with torch.no_grad():
        for c in m.modules():
            if isinstance(c, nn.Conv2d):
                cout, _, kh, kw = c.weight.shape
                c.weight.copy_(torch.randn(c.weight.shape, generator=rng)
                               * math.sqrt(2.0 / (kh * kw * cout)))
        lim = 1.0 / math.sqrt(m.fc.in_features)
        m.fc.weight.copy_((torch.rand(m.fc.weight.shape, generator=rng) * 2 - 1) * lim)
        m.fc.bias.zero_()
    return m.to(dev)


def init_e4e(seed: int = 0, image_resolution: int = 256,
             device: DeviceLike = None, cls=Encoder4Editing) -> Encoder4Editing:
    """The JAX package's ``init_e4e_encoder`` distributions: every conv
    (stem, body, SE gates, shortcuts, style heads, lateral layers) He-uniform
    U(±sqrt(6 / (in·kh·kw))) with zero biases, batch norm at identity
    statistics, PReLU slopes 0.25, equalized linears N(0, 1) with zero
    biases. ``cls``: a module of its layout (:class:`GradualStyleEncoder`),
    or :class:`BackboneEncoderUsingLastLayerIntoW` (the same rules; it
    takes no resolution)."""
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    e = (cls() if cls is BackboneEncoderUsingLastLayerIntoW else cls(image_resolution))
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


def init_id_backbone(seed: int = 0, input_size: int = 112,
                     device: DeviceLike = None) -> Backbone:
    """The JAX package's ``init_backbone`` distributions: every conv
    He-uniform U(±sqrt(6 / (in·kh·kw))), batch norm at identity statistics,
    PReLU slopes 0.25, the head's Linear U(±1/sqrt(in)) with a zero bias."""
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    m = Backbone(input_size)
    with torch.no_grad():
        for c in m.modules():
            if isinstance(c, nn.Conv2d):
                _, cin, kh, kw = c.weight.shape
                lim = math.sqrt(6.0 / (cin * kh * kw))
                c.weight.copy_((torch.rand(c.weight.shape, generator=rng) * 2 - 1) * lim)
            elif isinstance(c, nn.Linear):
                lim = 1.0 / math.sqrt(c.in_features)
                c.weight.copy_((torch.rand(c.weight.shape, generator=rng) * 2 - 1) * lim)
                c.bias.zero_()
    return m.to(dev)


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
