"""Raw frames in, reenacted faces out: ``make_fused_reenact_fn`` (SFD → FAN
→ FFHQ crop, DECA aligned by SFD + FAN, Δp → A, synthesis) in a closed
loop of one client, one chunk in flight.

Each chunk of raw uint8 frames is uploaded from pinned memory, run, and its
outputs (``outputs="full"``: reenacted uint8, latents, crops, masks,
landmarks) are downloaded to pinned memory. The source identity is made
once at set-up from the seed. The control runs the program's own bf16
path (``compute_dtype=bfloat16``)."""

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
    fn = port.make_fused_reenact_fn(
        n["g"], n["a"], n["deca"], spec, n["sfd"], n["fan"],
        truncation=run.cfg["directions"]["truncation"], truncation_latent=trunc,
        num_layers_shift=run.cfg["directions"]["num_layers_shift"], compute_dtype=dtype,
        fan_params=n["fan"], s3fd_params=n["sfd"], outputs="full", output_u8=True, device=dev)
    if run.fault is not None:
        fn = run.fault(fn)
    pool = traffic.frames(tr, run.seed, tr["pool_frames"], dev).cpu()
    if run.on_card:
        pool = pool.pin_memory()
    chunk = tr["chunk"]
    dev_in = torch.empty((chunk,) + tuple(pool.shape[1:]), dtype=torch.uint8, device=dev)
    host_out = []

    @torch.inference_mode()
    def step(i: int):
        j = (i * chunk) % pool.shape[0]
        dev_in.copy_(pool[j:j + chunk], non_blocking=True)
        outs = fn(*src, dev_in)
        if not host_out:
            host_out.extend(torch.empty(o.shape, dtype=o.dtype, pin_memory=run.on_card)
                            for o in outs)
        for h, o in zip(host_out, outs):
            h.copy_(o, non_blocking=True)
        run.sync()
        return j

    run.state.update(src=src, trunc=trunc, spec=spec, fn=fn, pool=pool, step=step,
                     host_out=host_out, dev_in=dev_in)
    run.readings["pool"] = pool
    for i in range(tr["warm_chunks"]):
        step(i)


def _record(run):
    def record(i: int, j: int) -> Dict:
        names = ("reenacted", "latents", "crops", "ok", "in_frame", "landmarks")
        return {"first": j, **{k: v.clone() for k, v in zip(names, run.state["host_out"])}}
    return record


def window(run, seconds: float):
    run.sample = Reservoir(run.seed, run.tr["check_chunks"])
    times, win = closed_loop(run.state["step"], seconds, run.sample, _record(run))
    run.readings["times"] = times
    frames = len(times) * run.tr["chunk"]
    e2e = {"frames_per_s": frames / win,
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
    rc.stage_spans(run, raw=True)
    run.readings["count_flops"] = True     # the check counts one chunk's FLOPs


def release(run) -> None:
    run.state.clear()


def check(run) -> Dict[str, float]:
    return rc.check(run, raw=True)
