"""What every run shares: the files a cell names, the card's description,
the run's flags, the result line, and the check for JAX in the process."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
PORT = "stylegan_directions_face_reenactment_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "stylegan_directions_face_reenactment_tpu")

# Published dense peaks of one NVIDIA H100 SXM (data sheet; 700 W)
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str) -> Dict:
    """The workload entry of ``name`` in BENCHMARK.json."""
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"port_bench: no workload named {name!r} in BENCHMARK.json")


def config(name: str) -> Dict:
    for c in benchmark()["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise SystemExit(f"port_bench: no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = os.path.join(ROOT, "build")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(build, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def nvidia_smi() -> Dict[str, str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {"name": "unknown", "power_limit": "unknown"}
    name, _, limit = (out[0] if out else "unknown, unknown").partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def device_info(torch, count: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def nearest_rank(values: List[float], q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q <= 1) of ``values``."""
    s = sorted(values)
    k = math.ceil(q * len(s) - 1e-9)
    return s[min(max(k, 1), len(s)) - 1]


def compared_lines(numbers: List[Dict]) -> List[str]:
    return [f"compared {n['name']}: {n['value']!r} (limit {n['limit']!r}, "
            f"{'ok' if n['ok'] else 'FAILED'})" for n in numbers]


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict,
                device: Dict, numbers: List[Dict],
                breakdown: Optional[Dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {n["name"]: {"value": n["value"], "limit": n["limit"]} for n in numbers}
    return json.dumps(out)
