"""A cell cut to a size the CPU runs in seconds, for the tests: the
configuration's generator at 32², FAN with one hourglass module, frames
of 160 rows at the detection width, chunks of 2."""

import copy

import torch

from harness import cell, common


def run_for(workload: str, seed: int = 2**31 + 11, fault=None, control: bool = False):
    w = common.cell(workload)
    cfg = copy.deepcopy(common.config(w["config"]))
    cfg["generator"].update(resolution=32, channel_multiplier=1)
    cfg["fan"]["num_modules"] = 1
    cfg["directions"]["num_layers_shift"] = 6     # of the 8 rows at 32², as 8 of 14 at 256²
    tr = dict(common.traffic(w["traffic"]))
    if "frame_hw" in tr:
        tr.update(frame_hw=[160, 1000], patch=48, margins=[30, 30, 60, 60], pool_frames=4)
    if "chunk" in tr:
        tr.update(chunk=2, warm_chunks=1, pool_frames=4, check_chunks=2)
    return cell.Run(w, cfg, tr, seed, torch.device("cpu"), control=control, fault=fault)


def result(run, seconds: float = 1.0):
    return cell.run_cell(run, seconds, False, 0.0)
