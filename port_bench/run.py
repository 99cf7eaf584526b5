"""The benchmark of the port, one cell one run:

  python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration and a traffic file; the run sets up the port from the seed,
measures for ``--seconds`` (``--trace 0``: the end-to-end metrics) or
traces a short window (``--trace 1``: the per-layer metrics), checks what
the timed path produced against the plain reference, and prints one JSON
line last. ``--control 1`` runs the cell's control in the program's place
(the check must then fail); the benchmark's own runs never set it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import common  # noqa: E402

common.cache_dirs()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from harness import cell

    workload = common.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        cell.say(f"needs {workload['chips']} CUDA device(s); found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(4)
    smi = common.nvidia_smi()
    cell.say(f"card {smi['name']}, power limit {smi['power_limit']}; torch {torch.__version__}",
             cell.flags())
    run = cell.Run(workload, common.config(workload["config"]), common.traffic(workload["traffic"]),
                   args.seed, torch.device("cuda", 0), control=bool(args.control))
    res = cell.run_cell(run, args.seconds, bool(args.trace), T_START)
    bad = common.forbidden_modules()
    if bad:
        cell.say(f"FAILED: modules of JAX or the JAX package were loaded: {', '.join(bad)}")
        return 3
    cell.say(cell.flags(), *common.compared_lines(res["numbers"]))
    print(common.result_line(res["correct"], res["attempted"], res["failed"], res["metrics"],
                             res["device"], res["numbers"], res["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
