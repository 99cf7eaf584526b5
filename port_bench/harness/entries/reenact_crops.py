"""FFHQ-aligned crops in, reenacted faces out: ``make_reenact_fn`` (DECA
aligned by SFD + FAN on the crop, Δp → A, synthesis) as the CLI's unfused
loop calls it with ``--skip_preprocess``: float32 crops in host memory
handed to the entry, its outputs copied back to host memory. A closed loop
of one client, one chunk in flight. The control runs the program's own
bf16 path (``compute_dtype=bfloat16``)."""

from __future__ import annotations

import importlib
from typing import Dict

import torch

from .. import common, nets, traffic
from ..loop import Reservoir, closed_loop
from . import reenact_common as rc


def setup(run) -> None:
    tr, dev = run.tr, run.device
    port = importlib.import_module(f"{common.PORT}.pipeline")
    run.state["nets"] = n = nets.port_nets(common.PORT, run.cfg, rc.NETS, run.seed, dev)
    src, trunc, spec = rc.port_source(run, n)
    dtype = torch.bfloat16 if run.control else torch.float32
    fn = port.make_reenact_fn(
        n["g"], n["a"], n["deca"], spec, truncation=run.cfg["directions"]["truncation"],
        truncation_latent=trunc, num_layers_shift=run.cfg["directions"]["num_layers_shift"],
        compute_dtype=dtype, fan_params=n["fan"], s3fd_params=n["sfd"], device=dev)
    if run.fault is not None:
        fn = run.fault(fn)
    pool = traffic.crops(tr, run.seed, tr["pool_frames"], dev).cpu()
    pool_np = pool.numpy()
    chunk = tr["chunk"]
    host_out = []

    def step(i: int):
        j = (i * chunk) % pool_np.shape[0]
        reen, lat = fn(*src, pool_np[j:j + chunk])
        host_out[:] = [reen.cpu(), lat.cpu()]
        return j

    run.state.update(src=src, trunc=trunc, spec=spec, fn=fn, step=step, host_out=host_out,
                     pool_dev=pool[:chunk].to(dev))
    run.readings["pool"] = pool
    for i in range(tr["warm_chunks"]):
        step(i)


def _record(run):
    def record(i: int, j: int) -> Dict:
        reen, lat = run.state["host_out"]
        return {"first": j, "reenacted": reen.clone(), "latents": lat.clone()}
    return record


def window(run, seconds: float):
    run.sample = Reservoir(run.seed, run.tr["check_chunks"])
    times, win = closed_loop(run.state["step"], seconds, run.sample, _record(run))
    run.readings["times"] = times
    e2e = {"frames_per_s": len(times) * run.tr["chunk"] / win,
           "chunk_p90_ms": 1e3 * common.nearest_rank(times, 0.9)}
    return e2e, len(times), 0


def traced(run) -> None:
    from ..trace import traced as profile
    st, tr = run.state, run.tr
    run.sample = Reservoir(run.seed, tr["check_chunks"])
    n = tr["trace_chunks"]

    def chunks():
        return [st["step"](i) for i in range(n)][-1]

    trace, last = profile(chunks)
    run.sample.offer(lambda: _record(run)(n - 1, last))
    run.readings.update(trace=trace, requests=n, attempted=n, failed=0,
                        itemsize=2 if run.control else 4,
                        ops=("sdfr::fused_conv_block", "sdfr::upfirdn2d"))
    rc.stage_spans(run, raw=False)
    run.readings["count_flops"] = True     # the check counts one chunk's FLOPs


def release(run) -> None:
    run.state.clear()


def check(run) -> Dict[str, float]:
    return rc.check(run, raw=False)
