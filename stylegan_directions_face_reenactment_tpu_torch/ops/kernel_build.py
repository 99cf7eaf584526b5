"""Builds and loads the hand-written CUDA kernels of ``csrc/``.

Every ``.cu`` file is compiled by its own ``nvcc`` (all started together)
for ``sm_90a`` into an object with a plain C interface; the objects are linked
into one shared library that is loaded with ``ctypes``. The library goes
into ``build/kernels/`` beside the package, named by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built when this module is imported: the first kernel launch, or
:func:`load_library`, builds.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("upfirdn2d.cu", "fused_bias_act.cu", "fused_conv_block.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# C entry points and their argument types; each returns cudaGetLastError().
SIGNATURES = {
    "upfirdn2d_run": (_P, _P, _P, _P),   # (&K1Params, x, y, stream)
    "fused_bias_act_f32": (_P, _P, _P, _I64, _I, _I64, _F, _F, _P),
    "fused_bias_act_bf16": (_P, _P, _P, _I64, _I, _I64, _F, _F, _P),
    "fused_bias_act_bwd_f32": (_P, _P, _P, _I64, _F, _F, _P),
    "fused_bias_act_bwd_bf16": (_P, _P, _P, _I64, _F, _F, _P),
    "fused_conv_block_f32": (_P,) * 14 + (_I,) * 6 + (_P,),
    "fused_conv_block_bf16": (_P,) * 14 + (_I,) * 6 + (_P,),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or nvcc on PATH)")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def _run(cmds: List[List[str]]) -> List[str]:
    """Run the commands together; return their stderr, raise on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    logs = []
    failed = []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        logs.append(out + err)
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}{err}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=1)
def build() -> Dict[str, object]:
    """Compile the kernels if their library is not built yet.

    Returns ``{"path", "seconds", "ptxas"}``: the library, the seconds this
    call spent compiling (0 when it was already built) and ``nvcc
    -Xptxas -v``'s report (registers, shared memory, spills per kernel).
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.join(BUILD_DIR, f"libreenact_kernels_{_digest()}")
    lib_path, log_path = stem + ".so", stem + ".ptxas.txt"
    if os.path.exists(lib_path) and os.path.exists(log_path):
        with open(log_path) as f:
            return {"path": lib_path, "seconds": 0.0, "ptxas": f.read()}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, name + ".o") for name in SOURCES]
        logs = _run([[nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, name),
                      "-o", obj] for name, obj in zip(SOURCES, objs)])
        tmp_lib = os.path.join(tmp, "lib.so")
        _run([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", tmp_lib, *objs]])
        with open(log_path, "w") as f:
            f.write("".join(logs))
        os.replace(tmp_lib, lib_path)
    return {"path": lib_path, "seconds": time.perf_counter() - t0,
            "ptxas": "".join(logs)}


def ptxas_summary(log: str) -> List[str]:
    """One line per compiled kernel: its name, registers, shared memory and
    spills (ptxas leaves out the shared memory when it is 0)."""
    lines, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f", spills {m.group(1)}/{m.group(2)} bytes"
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name is not None:
            lines.append(f"{name}: {m.group(1)} registers, "
                         f"{m.group(2) or 0} bytes smem{spills}")
            name = None
    return lines


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's arguments."""
    lib = ctypes.CDLL(build()["path"])
    for fn_name, argtypes in SIGNATURES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def on_card_of(x):
    """The device guard of a launch on ``x``: the C entry points launch on
    the current device, so a tensor on another card switches to that card
    for the call (the mesh's parts and each rank already run there)."""
    import torch
    if x.device.index is None or x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def check(status: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
