"""The readings a cell's limits are set from: the numbers compared, run
by run, for many seeds in one process (set-up is paid once for the
imports and the kernels' build):

  python3 port_bench/sweep.py --workload <cell> --seeds 11 12 13 --seconds 4 [--control 1]

Each seed sets up the cell anew, runs a short window at the cell's own
load, and prints one JSON line: the seed, ``correct``, every number
compared with its limit, and each checked frame's shift error.
``--control 1`` runs the cell's control in the program's place;
``--cudnn_tf32 0`` runs the program with cuDNN's TF32 off, a witness for
frames whose DECA alignment flips under TF32. Not part of a benchmark run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import common  # noqa: E402

common.cache_dirs()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--cudnn_tf32", type=int, choices=(0, 1), default=None,
                   help="set cuDNN's TF32 flag for the program (a witness run); "
                        "left as PyTorch has it by default")
    args = p.parse_args(argv)
    import torch
    from harness import cell

    if not torch.cuda.is_available():
        cell.say("needs a CUDA device")
        return 2
    torch.set_num_threads(4)
    if args.cudnn_tf32 is not None:
        torch.backends.cudnn.allow_tf32 = bool(args.cudnn_tf32)
    workload = common.cell(args.workload)
    for seed in args.seeds:
        run = cell.Run(workload, common.config(workload["config"]),
                       common.traffic(workload["traffic"]), seed, torch.device("cuda", 0),
                       control=bool(args.control))
        t0 = time.perf_counter()
        res = cell.run_cell(run, args.seconds, False, t0)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "cudnn_tf32": torch.backends.cudnn.allow_tf32,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "numbers": {n["name"]: [n["value"], n["limit"]]
                                      for n in res["numbers"]},
                          "frame_errors": run.readings.get("frame_errors"),
                          "seconds": time.perf_counter() - t0}), flush=True)
        del run, res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
