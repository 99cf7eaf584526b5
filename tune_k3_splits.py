#!/usr/bin/env python3
"""Sweep the split-K counts of K3 (the FAN ConvBlock kernel) on one CUDA card.

    python3 tune_k3_splits.py [--dtype bfloat16|float32] [--batch 16 1]

For every K3 shape of a FAN pass (``ops/main_path.py::fused_conv_block_calls``)
it prints the device time of one call (CUDA events around a replayed CUDA
graph, ``chip_smoke.device_ms``) under the schedule table
(``ops/fused_conv_block.py::schedule``) and, stage by stage, under each split
count from 1 up, the other stages held at the best count found so far. The
table's targets (``target_blocks``, ``MAX_SPLITS``) were chosen from these
sweeps. Run from the repository root; it builds the kernels on first use.
"""

import argparse

import torch

import chip_smoke as c
from stylegan_directions_face_reenactment_tpu_torch.ops import fused_conv_block as k3

SPLITS = (1, 2, 3, 4, 6, 9, 12, 18, 36, 72)


def with_chunks(table, chunks):
    """``table`` with the given K steps a block, its workspace to match."""
    def sched(b, h, w, dtype):
        m, ws = b * h * w, 0
        for (cin, cout), ch in zip(k3.STAGES, chunks):
            n = -(-(9 * cin // k3.k_step_channels(dtype)) // ch)
            if n > 1:
                ws = max(ws, n * m * cout)
        return table(b, h, w, dtype)._replace(kchunk=tuple(chunks), workspace=ws)
    return sched


def time_call(x, args):
    k3._plans.clear()             # a cached plan holds the schedule's chunks
    return 1e3 * c.device_ms(lambda: k3.fused_conv_block_cuda(x, args), reps=20)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--batch", nargs="+", type=int, default=[16, 1])
    opts = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    c.phase_device()
    c.phase_build()
    table = k3.schedule
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        for dtype in (getattr(torch, d) for d in opts.dtype):
            for batch in opts.batch:
                for shape, _, x, args in c.k3_inputs(dtype, gen, batch):
                    b, _, h, w = shape
                    base = table(b, h, w, dtype)
                    k3.schedule = table
                    line = [f"{shape} {str(dtype)[6:]} table splits {base.splits} "
                            f"{time_call(x, args):.1f} us"]
                    best = list(base.kchunk)
                    for st, (cin, _) in enumerate(k3.STAGES):
                        ks = 9 * cin // k3.k_step_channels(dtype)
                        res = []
                        for n in (n for n in SPLITS if n <= ks):
                            chunks = list(best)
                            chunks[st] = -(-ks // n)
                            k3.schedule = with_chunks(table, chunks)
                            res.append((time_call(x, args), n))
                        best[st] = -(-ks // min(res)[1])
                        line.append(f"stage {st + 1} " + " ".join(f"{n}:{t:.1f}" for t, n in res))
                    print("[tune] " + " | ".join(line), flush=True)
    finally:
        k3.schedule = table
        k3._plans.clear()


if __name__ == "__main__":
    main()
