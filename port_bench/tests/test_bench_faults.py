"""A whole run, on the CPU at a tiny size, passing the check; and the same
run with the timed path broken underneath, which the check has to refuse:
an answer altered where it is produced, half of a batch left out (its
answers repeated from the other half), and DECA's coefficients of each
frame taken from the next one inside the program's DECA stage."""

import importlib

import pytest
import torch

from harness import common
from tiny import result, run_for

REENACT = ["vox256.video", "ffhq1024.crops"]
SECONDS = 6.0


def _altered(fn):
    """The first frame's reenacted output inverted where it is produced."""
    def wrapped(*args):
        out = list(fn(*args))
        img = out[0].clone()
        img[0] = (255 - img[0]) if img.dtype == torch.uint8 else -img[0]
        out[0] = img
        return tuple(out)
    return wrapped


def _half(fn):
    """Only the first half of the chunk is computed; the second half
    repeats its answers."""
    def wrapped(*args):
        *src, frames = args
        out = fn(*src, frames[: frames.shape[0] // 2])
        return tuple(torch.cat([o, o]) for o in out)
    return wrapped


@pytest.mark.parametrize("workload", REENACT)
def test_sound_run_is_correct(workload):
    res = result(run_for(workload), SECONDS)
    assert res["correct"], res["numbers"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("workload", REENACT)
@pytest.mark.parametrize("fault", [_altered, _half], ids=["altered", "half"])
def test_reenact_fault_is_refused(workload, fault):
    res = result(run_for(workload, fault=fault), SECONDS)
    assert not res["correct"], res["numbers"]


@pytest.mark.parametrize("workload", REENACT)
def test_deca_rolled_is_refused(workload, monkeypatch):
    """Inside the program's DECA stage, each frame gets the next frame's
    coefficients; the rest of the path is left as it is."""
    mod = importlib.import_module(f"{common.PORT}.pipeline.reenactment")
    deca = mod.calculate_shapemodel

    def rolled(*args, **kwargs):
        params, angles = deca(*args, **kwargs)
        return {k: v.roll(1, dims=0) for k, v in params.items()}, angles.roll(1, dims=0)

    monkeypatch.setattr(mod, "calculate_shapemodel", rolled)
    res = result(run_for(workload), SECONDS)
    assert not res["correct"], res["numbers"]
    bad = {n["name"] for n in res["numbers"] if not n["ok"]}
    assert bad & {"shift_rel", "shift_frames_off"}, res["numbers"]
