"""One run of one cell: set-up, the measured or traced window, the
comparison with the plain reference, and the result line.

The cell's traffic file names its entry (``harness/entries/<entry>.py``),
which drives the port through the window; its configuration file gives
the nets' sizes; ``limits/<cell>.json`` gives the limit of every number
compared; ``metrics/<metric>.py`` reads each per-layer metric from what
the traced run left in ``Run.readings``."""

from __future__ import annotations

import gc
import importlib.util
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from . import common


class Run:
    def __init__(self, workload: Dict, cfg: Dict, tr: Dict, seed: int,
                 device: torch.device, control: bool = False,
                 fault: Optional[Callable] = None):
        self.workload, self.cfg, self.tr, self.seed = workload, cfg, tr, seed
        self.device, self.control, self.fault = device, control, fault
        self.limits = common.load_json(
            os.path.join(common.BENCH_DIR, "limits", f"{workload['name']}.json"))
        self.state: Dict = {}
        self.readings: Dict = {}
        self.sample = None

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)


def entry(tr: Dict):
    return importlib.import_module(f"harness.entries.{tr['entry']}")


def per_layer_names(workload: str) -> List[Dict]:
    out = []
    for m in common.benchmark()["per_layer"]:
        if "workloads" not in m or workload in m["workloads"]:
            out.append(m)
    return out


def read_metric(name: str, run: Run) -> Optional[float]:
    path = os.path.join(common.BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def compare(run: Run, values: Dict[str, float]) -> List[Dict]:
    """Every number compared beside its limit; a number above its limit,
    or one that is not finite, fails."""
    out = []
    for name, limit in run.limits.items():
        v = values.get(name)
        ok = v is not None and v == v and v <= limit
        out.append({"name": name, "value": v, "limit": limit, "ok": bool(ok)})
    for name in values:
        if name not in run.limits:
            out.append({"name": name, "value": values[name], "limit": None, "ok": True})
    return out


def run_cell(run: Run, seconds: float, trace: bool, t_start: float) -> Dict:
    """Set-up, window (or traced window), reference check. Returns the
    pieces of the result line."""
    ent = entry(run.tr)
    ent.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t_start
    metrics: Dict[str, Dict] = {}
    attempted = failed = 0
    breakdown = None
    device = None
    if trace:
        ent.traced(run)
        tr = run.readings["trace"]
        attempted, failed = run.readings["attempted"], run.readings["failed"]
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
        from .trace import op_summary
        say(f"traced window {tr.window_s:.3f} s, device busy {tr.busy_s():.3f} s",
            *(op_summary(tr, op) for op in run.readings.get("ops", ())))
        busy = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
    else:
        e2e, attempted, failed = ent.window(run, seconds)
        units = {m["name"]: m["unit"] for m in common.benchmark()["end_to_end"]}
        for k, v in e2e.items():
            metrics[k] = {"value": v, "unit": units.get(k, "")}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        times = sorted(run.readings.get("times", []))
        if times:
            say(f"window: {len(times)} requests, seconds min {times[0]:.4f} median "
                f"{times[len(times) // 2]:.4f} max {times[-1]:.4f}")
    if run.on_card:
        device = common.device_info(torch, run.workload["chips"])
        if trace:
            device.update(busy)
    ent.release(run)
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()
    numbers = compare(run, ent.check(run))
    if trace:
        for m in per_layer_names(run.workload["name"]):
            v = read_metric(m["name"], run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = all(n["ok"] for n in numbers) and failed == 0
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device, "numbers": numbers,
            "breakdown": breakdown}


def flags() -> str:
    return (f"precision: torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def say(*lines: str) -> None:
    for line in lines:
        print(f"port_bench: {line}", file=sys.stderr, flush=True)
