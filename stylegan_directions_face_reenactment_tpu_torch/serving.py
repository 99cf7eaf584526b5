"""Serving bundles: the reenactment program as a deployable artifact.

Counterpart of the JAX package's ``serving.py``. The whole per-frame program
of ``pipeline/reenactment.py::make_reenact_program`` (DECA alignment →
encode → Δp → A → StyleGAN2 synthesis) is exported once with
``torch.export`` at a fixed frame batch; a server process loads it with
``torch.export.load`` and runs it without importing any model-building
code, converting checkpoints or tracing Python again. The kernels stay
kernels in the exported graph: it calls them by name as the operators
``sdfr::upfirdn2d``, ``sdfr::fused_bias_act`` and ``sdfr::fused_conv_block``
(``ops/``), which this module registers by importing ``ops/`` alone.

A torch program holds one device, so a bundle is for one platform:
``cuda`` (the default; exported on the card) or ``cpu``. Where the JAX
exporter lowers one artifact for several platforms, this one takes one
and refuses more.

Bundle layout (a directory):

- ``reenact.pt2``: the ``torch.export.save``d program. Its weights are
  arguments, not constants, and it keeps no example inputs, so it holds
  none of them.
- ``weights.npz`` + ``weights_tree.json``: the weights tree
  (``ReenactProgram.weights``: state dicts of G, A, DECA, FAN and S3FD,
  the truncation latent, K3's folds and packed weights) as a plain npz
  archive and a JSON manifest of its structure, as the JAX package's
  format v2: no pickle; the npz loads with ``allow_pickle=False``. bf16
  leaves are stored as their 16-bit patterns, the manifest naming their
  dtype. Weights ride as arguments so that a PTI-tuned generator can be
  swapped in (:meth:`ReenactServingProgram.with_generator`).
- ``meta.json``: the JAX package's keys (format version, frame batch,
  shapes, dtypes, alignment, platforms), with ``torch_version`` in place of
  ``jax_version`` and this package's own ``format_version``.

The exported program has a FIXED frame batch; :class:`ReenactServingProgram`
serves requests of any length by chunking and padding to that batch.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from .ops import fused_act, fused_conv_block, upfirdn2d_kernel  # noqa: F401  (registers sdfr::*)

FORMAT_VERSION = "torch-1"   # the JAX package's bundles are format 2
PROGRAM_FILE = "reenact.pt2"
WEIGHTS_FILE = "weights.npz"
WEIGHTS_TREE_FILE = "weights_tree.json"
META_FILE = "meta.json"
PLATFORMS = ("cuda", "cpu")
CROP_SIZE = 256          # ``pipeline/source_setup.py``'s, which a server does not import
_SOURCE_PARAM_DIMS = (("pose", 6), ("alpha_shp", 100), ("alpha_exp", 50), ("cam", 3))


def _encode_tree(x, leaves: list):
    """Weights tree → JSON-safe manifest; arrays appended to ``leaves``
    (bf16 as their uint16 bit patterns)."""
    if x is None:
        return {"t": "none"}
    if isinstance(x, dict):
        return {"t": "dict", "items": {k: _encode_tree(v, leaves) for k, v in x.items()}}
    if isinstance(x, (list, tuple)):
        return {"t": "tuple" if isinstance(x, tuple) else "list",
                "items": [_encode_tree(v, leaves) for v in x]}
    t = x.detach().cpu()
    dtype = str(t.dtype).replace("torch.", "")
    leaves.append(t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16
                  else t.numpy())
    return {"t": "leaf", "i": len(leaves) - 1, "dtype": dtype}


def _decode_tree(node, leaves, device):
    t = node["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _decode_tree(v, leaves, device) for k, v in node["items"].items()}
    if t in ("tuple", "list"):
        seq = [_decode_tree(v, leaves, device) for v in node["items"]]
        return tuple(seq) if t == "tuple" else seq
    a = torch.from_numpy(np.asarray(leaves[node["i"]], order="C"))   # 0-d stays 0-d
    if node["dtype"] == "bfloat16":
        a = a.view(torch.bfloat16)
    return a.to(device)


def local_platform() -> str:
    """The platform this process serves on: ``cuda`` with a card, else
    ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _one_platform(platforms) -> str:
    platforms = tuple(platforms) if platforms else ("cuda",)
    if len(platforms) != 1 or platforms[0] not in PLATFORMS:
        raise ValueError(f"a torch bundle is for one platform of {PLATFORMS}, got "
                         f"{list(platforms)}: a torch program holds one device")
    return platforms[0]


def reenact_arg_specs(weights, *, n_latent: int, frame_batch: int,
                      target_size: int = CROP_SIZE, reuse_landmarks: bool = False,
                      device="cuda") -> Tuple:
    """Example arguments of ``make_reenact_program``'s ``fn`` at these
    shapes, on ``device``: the weights tree itself, then zeros (the values
    do not matter to ``torch.export``, only shapes and dtypes)."""
    z = dict(dtype=torch.float32, device=device)
    args = (weights, torch.zeros(1, n_latent, 512, **z),
            {k: torch.zeros(1, n, **z) for k, n in _SOURCE_PARAM_DIMS},
            torch.zeros(1, 3, **z),
            torch.zeros(frame_batch, target_size, target_size, 3, **z))
    if reuse_landmarks:
        args += (torch.zeros(frame_batch, 68, 2, **z),
                 torch.ones(frame_batch, dtype=torch.bool, device=device))
    return args


class _Exportable(torch.nn.Module):
    """``fn(weights, ...)`` as a module with no parameters of its own, so
    that the exported program takes every weight as an argument."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, weights, source_code, params_source, angles_source, target_imgs,
                target_lms=None, target_ok=None):
        extra = () if target_lms is None else (target_lms, target_ok)
        return self._fn(weights, source_code, params_source, angles_source, target_imgs,
                        *extra)


def export_reenact(g, a, deca, spec, *, frame_batch: int = 16, truncation: float = 0.7,
                   truncation_latent: Optional[torch.Tensor] = None,
                   num_layers_shift: int = 8, compute_dtype: torch.dtype = torch.float32,
                   fan_params=None, s3fd_params=None, return_target_params: bool = False,
                   reuse_landmarks: bool = False, target_size: int = CROP_SIZE,
                   platforms: Optional[Tuple[str, ...]] = None):
    """Export the reenactment program → (ExportedProgram, weights, meta).

    ``platforms``: one of ``("cuda",)`` (the default) and ``("cpu",)``; the
    modules are moved there and the program is traced on that device.
    """
    from .models.stylegan2 import n_latent_for
    from .pipeline.reenactment import make_reenact_program

    platform = _one_platform(platforms)
    fn, weights = make_reenact_program(
        g, a, deca, spec, truncation=truncation, truncation_latent=truncation_latent,
        num_layers_shift=num_layers_shift, compute_dtype=compute_dtype,
        fan_params=fan_params, s3fd_params=s3fd_params,
        return_target_params=return_target_params, reuse_landmarks=reuse_landmarks,
        device=platform)
    n_latent = n_latent_for(g.size)
    args = reenact_arg_specs(weights, n_latent=n_latent, frame_batch=frame_batch,
                             target_size=target_size, reuse_landmarks=reuse_landmarks,
                             device=platform)
    with torch.no_grad():
        exported = torch.export.export(_Exportable(fn), args, strict=False)
    exported.example_inputs = None    # else torch.export.save stores them: the weights
    meta = {
        "format_version": FORMAT_VERSION,
        "frame_batch": int(frame_batch),
        "generator_size": int(g.size),
        "n_latent": int(n_latent),
        "target_size": int(target_size),
        "truncation": float(truncation),
        "num_layers_shift": int(num_layers_shift),
        "compute_dtype": str(compute_dtype).replace("torch.", ""),
        "deca_alignment": ("fan" if s3fd_params is not None else
                           "fan_frame" if fan_params is not None else "resize"),
        "return_target_params": bool(return_target_params),
        "reuse_landmarks": bool(reuse_landmarks),
        "platforms": [platform],
        "torch_version": torch.__version__,
    }
    return exported, weights, meta


def save_reenact_bundle(path: str, exported, weights, meta: Dict[str, Any]) -> None:
    """Write a serving bundle directory (see the module docstring)."""
    os.makedirs(path, exist_ok=True)
    torch.export.save(exported, os.path.join(path, PROGRAM_FILE))
    leaves: list = []
    manifest = _encode_tree(weights, leaves)
    np.savez(os.path.join(path, WEIGHTS_FILE), **{f"w{i}": a for i, a in enumerate(leaves)})
    with open(os.path.join(path, WEIGHTS_TREE_FILE), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _state_of(g) -> Dict[str, torch.Tensor]:
    if isinstance(g, torch.nn.Module):
        return {k: v.detach() for k, v in g.state_dict(keep_vars=True).items()}
    return dict(g)


class ReenactServingProgram:
    """A loaded bundle, callable as ``make_reenact_fn``'s result:
    ``fn(source_code, params_source, angles_source, target_imgs[,
    target_lms, target_ok])`` with ANY number of target frames, under
    ``torch.inference_mode()`` on the bundle's device. Requests are cut into
    chunks of the exported ``frame_batch``; a short chunk is padded by
    repeating its last frame (so the alignment nets see a valid face), and
    the padding is sliced off every output, dict outputs included. Inputs
    may be numpy arrays or tensors; outputs are tensors on the device."""

    def __init__(self, exported, weights, meta: Dict[str, Any], device: torch.device):
        self.meta = meta
        self.frame_batch = int(meta["frame_batch"])
        self.weights = weights
        self.device = device
        self._exported = exported
        self._call = _FlatCall(exported, weights, device)

    @property
    def platforms(self):
        return tuple(self.meta["platforms"])

    def with_generator(self, g) -> "ReenactServingProgram":
        """The same program with another generator's weights (a module or
        its state dict), the PTI serving pattern: one exported program, one
        tuned generator per source identity (``pipeline/pti.py::optimize_g``).
        Its keys, shapes and dtypes must be the exported generator's."""
        new, old = _state_of(g), self.weights["g"]
        if set(new) != set(old) or any(new[k].shape != old[k].shape
                                       or new[k].dtype != old[k].dtype for k in old):
            raise ValueError("with_generator takes a generator of the exported "
                             "architecture (the same keys, shapes and dtypes)")
        weights = dict(self.weights, g={k: v.to(self.device) for k, v in new.items()})
        return ReenactServingProgram(self._exported, weights, self.meta, self.device)

    def __call__(self, source_code, params_source, angles_source, target_imgs, *extra):
        dev, fb = self.device, self.frame_batch

        def to_dev(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        target_imgs = to_dev(target_imgs)
        extra = tuple(to_dev(e, torch.bool if i == 1 else torch.float32)
                      for i, e in enumerate(extra))
        fixed = (to_dev(source_code), {k: to_dev(v) for k, v in params_source.items()},
                 to_dev(angles_source))
        outs = []
        with torch.inference_mode():
            for start in range(0, target_imgs.shape[0], fb):
                chunk = [t[start:start + fb] for t in (target_imgs,) + extra]
                n = chunk[0].shape[0]
                if n < fb:
                    chunk = [torch.cat([c, c[-1:].expand((fb - n,) + c.shape[1:])])
                             for c in chunk]
                res = self._call(*fixed, *chunk)
                outs.append(_tree_map(lambda x, n=n: x[:n], res))
        if not outs:
            raise ValueError("empty target batch")
        if len(outs) == 1:
            return outs[0]
        return _tree_map(lambda *xs: torch.cat(xs, dim=0), *outs)


def _native_calls():
    """ATen overloads of the served graph and the Python bindings that call
    the same kernels with the same positional arguments and keywords: an
    ``OpOverload`` call parses its arguments through the boxed dispatcher,
    about 2.5 µs more than the binding (6.7 µs for ``conv2d``, on the dev
    box's CPU). Tensor methods are (``"method"``, name)."""
    aten, nn = torch.ops.aten, torch._C._nn
    return {
        aten.mul.Tensor: torch.mul, aten.add.Tensor: torch.add, aten.sub.Tensor: torch.sub,
        aten.div.Tensor: torch.div, aten.select.int: torch.select,
        aten.reshape.default: torch.reshape, aten.unsqueeze.default: torch.unsqueeze,
        aten.conv2d.default: torch.conv2d, aten.clamp_min.default: torch.clamp_min,
        aten.clamp.default: torch.clamp, aten.rsqrt.default: torch.rsqrt,
        aten.neg.default: torch.neg, aten.permute.default: torch.permute,
        aten.linear.default: nn.linear, aten.cat.default: torch.cat,
        aten.stack.default: torch.stack, aten.where.self: torch.where,
        aten.square.default: torch.square, aten.sum.dim_IntList: torch.sum,
        aten.matmul.default: torch.matmul, aten.t.default: torch.t,
        aten.gt.Scalar: torch.gt, aten.any.dim: torch.any,
        aten.avg_pool2d.default: nn.avg_pool2d, aten.full_like.default: torch.full_like,
        aten.zeros_like.default: torch.zeros_like, aten.arange.default: torch.arange,
        aten.__and__.Tensor: torch.bitwise_and, aten.bitwise_not.default: torch.bitwise_not,
        aten.max_pool2d.default: torch.max_pool2d, aten.softmax.int: torch.softmax,
        aten.exp.default: torch.exp, aten.gather.default: torch.gather,
        aten.trunc.default: torch.trunc,
        aten.to.dtype: ("method", "to"), aten.copy_.default: ("method", "copy_"),
        aten.expand.default: ("method", "expand"),
    }


def _lean(gm):
    """The graph module with what a served call need not pay for on the
    host: export's per-call metadata assertions removed, casts to a tensor's
    own dtype (eager returns the tensor itself) replaced by the tensor, and
    the commonest ATen overloads called through their Python bindings
    (:func:`_native_calls`). In a bf16 program the first two were 1,566 of
    4,115 calls."""
    aten = torch.ops.aten
    native = _native_calls()
    graph = gm.graph
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is aten._assert_tensor_metadata.default and not node.users:
            graph.erase_node(node)
            continue
        if node.target is aten.to.dtype:
            src, dtype = node.args[0], node.args[1]
            val = getattr(src, "meta", {}).get("val")
            copy = (node.args[3] if len(node.args) > 3 else node.kwargs.get("copy", False))
            if (val is not None and val.dtype == dtype and not copy
                    and node.kwargs.get("memory_format") is None):
                node.replace_all_uses_with(src)
                graph.erase_node(node)
                continue
        target = native.get(node.target)
        if target is not None and node.target is aten.expand.default and node.kwargs:
            target = None                # Tensor.expand takes no ``implicit``
        if isinstance(target, tuple):
            node.op, node.target = "call_method", target[1]
        elif target is not None:
            node.target = target
    gm.recompile()
    return gm


class _FlatCall:
    """The exported graph called on flat inputs: the weights flattened once,
    the graph's lifted constants placed once, each call flattening only the
    request's few arguments. ``ExportedProgram.module()`` would flatten and
    check every one of the weights' ~1,500 tensors on every call (tens of
    ms of host time a chunk on the card's host)."""

    def __init__(self, exported, weights, device):
        from torch.export.graph_signature import InputKind, OutputKind
        self.graph = _lean(exported.graph_module)
        sig = exported.graph_signature
        self.in_spec, self.out_spec = exported.call_spec.in_spec, exported.call_spec.out_spec
        self.flat_weights, self.weights_spec = pytree.tree_flatten(weights)
        self.slots = []          # per graph input: a fixed tensor, or None (the next user input)
        for spec in sig.input_specs:
            if spec.kind == InputKind.USER_INPUT:
                self.slots.append(None)
            elif spec.kind == InputKind.CONSTANT_TENSOR:
                self.slots.append(exported.constants[spec.target].to(device))
            elif spec.kind in (InputKind.PARAMETER, InputKind.BUFFER):
                self.slots.append(exported.state_dict[spec.target].to(device))
            else:
                raise ValueError(f"a serving program takes no {spec.kind} input")
        self.user_outputs = [i for i, o in enumerate(sig.output_specs)
                             if o.kind == OutputKind.USER_OUTPUT]
        self.args_spec = None    # the request's structure, once held against in_spec

    def __call__(self, *args):
        rest, rest_spec = pytree.tree_flatten(args)
        if rest_spec != self.args_spec:
            tree = pytree.tree_unflatten(self.flat_weights, self.weights_spec)
            if pytree.tree_flatten(((tree,) + args, {}))[1] != self.in_spec:
                raise ValueError("the request's arguments do not match the exported "
                                 "program's")
            self.args_spec = rest_spec
        user = iter(self.flat_weights + rest)
        inputs = [next(user) if slot is None else slot for slot in self.slots]
        out = self.graph(*inputs)
        return pytree.tree_unflatten([out[i] for i in self.user_outputs], self.out_spec)


def load_reenact_bundle(path: str) -> ReenactServingProgram:
    """A bundle directory → a callable serving program on this process's
    platform. Imports no model code (only ``ops/``, for its operators) and
    converts no checkpoint; reads no pickle."""
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported bundle format_version {meta.get('format_version')!r} "
                         f"(this build reads {FORMAT_VERSION!r}); re-export the bundle")
    local = local_platform()
    if local not in meta["platforms"]:
        raise ValueError(f"bundle was exported for platforms {meta['platforms']} but this "
                         f"process serves on '{local}'; re-export with --platforms {local}")
    device = torch.device(local)
    exported = torch.export.load(os.path.join(path, PROGRAM_FILE))
    with np.load(os.path.join(path, WEIGHTS_FILE), allow_pickle=False) as z:
        leaves = [z[f"w{i}"] for i in range(len(z.files))]
    with open(os.path.join(path, WEIGHTS_TREE_FILE)) as f:
        weights = _decode_tree(json.load(f), leaves, device)
    return ReenactServingProgram(exported, weights, meta, device)
