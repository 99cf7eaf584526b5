"""The scaling layer: device meshes, the process world, batch placement and
frame data parallelism (the JAX package's ``parallel/mesh.py``; the
reference runs on one device).

Two kinds of parallelism, as in the JAX package:

* **Training** is data parallel over processes, one card a process (NCCL),
  or CPU processes (gloo). Every rank holds the same frozen nets and the
  same A, takes its rows of the global batch (:func:`shard_batch`), and the
  step averages A's gradient over the world before Adam
  (:func:`average_over_world`), so a world of P makes one card's update.
  :func:`distributed_init` joins the world from torchrun's environment;
  :func:`launch` spawns a world on this host.
* **Inference** is frame data parallelism in one process
  (:func:`data_parallel`): a frame batch splits over the mesh's devices,
  each part runs on its device's copy of the nets, and the outputs are
  gathered in frame order on the first device.

A :class:`Mesh` is a grid of ``torch.device`` s with named axes: ``dp``, or
``(dcn, dp)`` for several hosts (:func:`make_hybrid_mesh`). Nothing here
imports JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import pickle
import queue
import socket
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

DATA_AXIS = "dp"
DCN_AXIS = "dcn"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a mesh, row-major over ``grid``, and its axis names."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    grid: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.grid))

    @property
    def size(self) -> int:
        return len(self.devices)


def _available(device) -> List[torch.device]:
    """The devices a mesh may take: every CUDA card (it raises when there is
    none), or one CPU slot for ``device="cpu"``."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    from ..utils.device import resolve_device
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _pick(n_devices: Optional[int], devices, device) -> List[torch.device]:
    if devices is None:
        devices = _available(device)
        if devices[0].type == "cpu":
            # the CPU has as many slots as asked for: the tests' counterpart
            # of the JAX tests' virtual CPU devices
            return devices * (n_devices or 1)
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested a {n_devices}-device mesh but only "
                             f"{len(devices)} device(s) are available")
        devices = devices[:n_devices]
    return devices


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence[Any]] = None,
              device=None, axis_name: str = DATA_AXIS) -> Mesh:
    """A 1-D data-parallel mesh: ``cuda:0..n-1`` (every card by default;
    ``ValueError`` past ``torch.cuda.device_count()``), ``n`` slots on the
    CPU with ``device="cpu"``, or the ``devices`` given."""
    devs = _pick(n_devices, devices, device)
    return Mesh(tuple(devs), (axis_name,), (len(devs),))


def make_hybrid_mesh(n_devices: Optional[int] = None, dcn_slices: int = 1,
                     devices: Optional[Sequence[Any]] = None, device=None,
                     axis_names: Sequence[str] = (DCN_AXIS, DATA_AXIS)) -> Mesh:
    """A 2-D ``(dcn, dp)`` mesh: one row per host. In a world of several
    processes (after :func:`distributed_init`) it describes the world, one
    card a rank: ``dcn_slices`` must divide the world, and ``n_devices``
    cannot restrict it. In one process the devices fold into the grid."""
    if dcn_slices < 1:
        raise ValueError(f"dcn_slices must be >= 1, got {dcn_slices}")
    rank, world = world_info()
    if devices is None and world > 1:
        if world % dcn_slices:
            raise ValueError(f"multi-process hybrid mesh: dcn_slices ({dcn_slices}) must "
                             f"divide the world ({world} ranks): one row per host")
        if n_devices is not None and n_devices != world:
            raise ValueError(f"n_devices ({n_devices}) cannot restrict a multi-process "
                             f"mesh: all {world} ranks take part")
        local = world // dcn_slices
        kind = "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"
        devs = [torch.device(kind) if kind == "cpu" else torch.device(kind, r % local)
                for r in range(world)]
        return Mesh(tuple(devs), tuple(axis_names), (dcn_slices, local))
    devs = _pick(n_devices, devices, device)
    if len(devs) % dcn_slices:
        raise ValueError(f"dcn_slices {dcn_slices} must divide the device count "
                         f"{len(devs)}")
    return Mesh(tuple(devs), tuple(axis_names), (dcn_slices, len(devs) // dcn_slices))


# ---------------------------------------------------------------------------
# the process world
# ---------------------------------------------------------------------------

def world_info() -> Tuple[int, int]:
    """(this process's rank, the world's size); (0, 1) outside a world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def distributed_init(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, device=None) -> bool:
    """Join the process world (the JAX package's ``jax.distributed``
    set-up). The arguments fall back to torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``). With nothing configured it touches nothing and returns
    False. Otherwise it joins with NCCL on the card (after selecting the
    card ``LOCAL_RANK``) or gloo with ``device="cpu"``, and returns True."""
    if dist.is_initialized():
        return True
    env = os.environ
    world_size = world_size if world_size is not None else (
        int(env["WORLD_SIZE"]) if env.get("WORLD_SIZE") else None)
    if init_method is None and world_size is None and not env.get("MASTER_ADDR"):
        return False
    rank = rank if rank is not None else int(env.get("RANK", "0"))
    if init_method is None:
        init_method = f"tcp://{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    on_cpu = device is not None and torch.device(device).type == "cpu"
    kw = {}
    if not on_cpu:
        from ..utils.device import resolve_device
        resolve_device(None)
        kw["device_id"] = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group("gloo" if on_cpu else "nccl", init_method=init_method,
                            world_size=world_size if world_size is not None else 1, rank=rank,
                            **kw)
    return True


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, world: int, port: int, backend: str, threads: int, fn: Callable,
                args: tuple, results) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    # the world shares its parent's cores
    torch.set_num_threads(max(1, threads // world))
    # gloo: the CPU, or several ranks on one card; NCCL: card LOCAL_RANK
    distributed_init(device="cpu" if backend == "gloo" else None)
    try:
        # plain pickle bytes: a tensor in the result is copied, not shared
        # through a file descriptor that dies with this process
        results.put((rank, pickle.dumps(fn(*args))))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, *args, backend: str = "nccl",
           timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` spawned processes of one world on
    this host, rank r with torchrun's environment variables set (a free
    port a world), and return the ranks' results in rank order. With
    ``"nccl"`` rank r takes card r; with ``"gloo"`` the ranks' devices are
    ``fn``'s choice (the CPU, or several ranks on one card, which NCCL
    refuses). Each rank takes its share of this process's torch threads.
    ``fn`` and its arguments and results are pickled: a module-level
    function, and results on the CPU. Raises when a rank fails or
    ``timeout`` seconds pass."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(r, world, port, backend, torch.get_num_threads(), fn, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    out: Dict[int, Any] = {}
    try:
        # the results are read before the ranks are joined: a rank whose
        # result fills the pipe exits only once it is read
        while len(out) < world:
            try:
                r, v = results.get(timeout=1.0)
                out[r] = pickle.loads(v)
            except queue.Empty:
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"ranks {failed} of a world of {world} failed (exit "
                                       f"codes {[procs[r].exitcode for r in failed]})")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world} ran past {timeout} s")
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def rank_rows(n: int, rank: Optional[int] = None, world: Optional[int] = None,
              groups: int = 1) -> np.ndarray:
    """The rows of a global batch of ``n`` that rank ``rank`` of ``world``
    owns: the contiguous block ``[p·n/P, (p+1)·n/P)`` (the JAX package's
    row-major batch sharding). With ``groups`` > 1 the batch is that many
    equal consecutive groups (the halves of a disentanglement-50 or
    real_synthetic batch, the microbatches of an accumulated step) and the
    rank owns its block of each group, so that its part is again a batch
    of the same groups."""
    if rank is None or world is None:
        rank, world = world_info()
    if n % (groups * world):
        what = "global batch" if groups == 1 else f"each of the {groups} groups of the batch"
        raise ValueError(f"{what} ({n // groups} rows) must divide the process count {world}")
    size = n // groups
    per = size // world
    return np.concatenate([np.arange(g * size + rank * per, g * size + (rank + 1) * per)
                           for g in range(groups)])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, str):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, rank: Optional[int] = None, world: Optional[int] = None,
                groups: int = 1):
    """This rank's rows (:func:`rank_rows`) of every array or tensor of a
    tree; other leaves pass through. Every rank passes the same global
    batch (every rank draws and reads the same), and keeps its part."""
    def take(x):
        if isinstance(x, torch.Tensor):
            return x[torch.from_numpy(rank_rows(x.shape[0], rank, world, groups)).to(x.device)]
        if isinstance(x, np.ndarray):
            return x[rank_rows(x.shape[0], rank, world, groups)]
        return x
    return _tree_map(take, batch)


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _coalesced(tensors: List[torch.Tensor], collective: Callable) -> None:
    """Run ``collective`` on one flat buffer per (device, dtype) of the
    tensors and write the results back in place."""
    groups: Dict[Tuple[torch.device, torch.dtype], List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        collective(flat)
        off = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


def replicate(tree, src: int = 0):
    """Give every rank rank ``src``'s values of every tensor of a tree (the
    parameters and buffers of modules, a dataclass's fields, tensors in
    dicts and lists), in place; the tree is returned. Every rank loads the
    same weights, so this only makes sure. Outside a world it does
    nothing."""
    if world_info()[1] > 1:
        _coalesced(_tensors(tree), lambda flat: dist.broadcast(flat, src))
    return tree


def average_over_world(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors' means over the ranks, in place, with one all-reduce a
    (device, dtype); the tensors themselves outside a world."""
    world = world_info()[1]
    if world > 1:
        def mean(flat):
            dist.all_reduce(flat)
            flat.div_(world)
        _coalesced(tensors, mean)
    return tensors


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad a host batch so it divides the mesh; returns (padded, real_len)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad, mode="edge"), n


# ---------------------------------------------------------------------------
# frame data parallelism in one process
# ---------------------------------------------------------------------------

def _to(x, dev: torch.device, modules: Dict[Tuple[int, torch.device], nn.Module]):
    """``x`` on ``dev``: tensors copied, modules copied once (kept in
    ``modules``), containers walked, anything else as it is."""
    if isinstance(x, nn.Module):
        if next(iter(_tensors(x)), torch.empty(0, device=dev)).device == dev:
            return x
        key = (id(x), dev)
        if key not in modules:
            modules[key] = copy.deepcopy(x).to(dev)
        return modules[key]
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=True)
    if isinstance(x, dict):
        return {k: _to(v, dev, modules) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not isinstance(x, str):
        return type(x)(_to(v, dev, modules) for v in x)
    return x


def _gather(parts: List[Any], dev: torch.device):
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(dev) for p in parts], dim=0)
    if isinstance(first, dict):
        return {k: _gather([p[k] for p in parts], dev) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_gather([p[i] for p in parts], dev) for i in range(len(first)))
    return first


def data_parallel(fn: Callable, mesh: Mesh, batch_argnums: Sequence[int] = (0,),
                  replicated: Sequence[Optional[nn.Module]] = ()) -> Callable:
    """``fn`` over the mesh (the JAX package's ``data_parallel_jit``): the
    batch arguments (tensors, dicts of them or None, split on axis 0, which
    the mesh must divide) go one part a device, the other arguments
    (tensors, modules and trees of them) to each part's device, and ``fn``
    runs on the parts one after another with no synchronization between
    them, each under its card's device guard. A module is copied to a
    device once: the ``replicated`` ones here, when the wrapper is built,
    any other at its first call. The results (tensors, or trees of them)
    are gathered in order on the first device along axis 0, so ``fn`` must
    treat rows independently."""
    devs = mesh.devices
    copies: Dict[Tuple[int, torch.device], nn.Module] = {}
    for dev in devs:
        for m in replicated:
            _to(m, dev, copies)

    def split(x, n):
        if x is None:
            return [None] * n
        if isinstance(x, torch.Tensor):
            if x.shape[0] % n:
                raise ValueError(f"the batch {x.shape[0]} must divide the {n}-device mesh")
            return list(x.chunk(n, dim=0))
        if isinstance(x, dict):
            parts = {k: split(v, n) for k, v in x.items()}
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        raise TypeError(f"a batch argument must be a tensor, a dict of them or None, "
                        f"not {type(x)}")

    def wrapped(*args):
        n = len(devs)
        split_args = {i: split(args[i], n) for i in batch_argnums}
        outs = []
        for j, dev in enumerate(devs):
            part = [_to(split_args[i][j] if i in split_args else a, dev, copies)
                    for i, a in enumerate(args)]
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    outs.append(fn(*part))
            else:
                outs.append(fn(*part))
        return _gather(outs, devs[0])

    return wrapped
