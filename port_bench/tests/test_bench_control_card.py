"""On the card, at each cell's own size: the control, the cell's next
lower precision put in the program's place, has to come out as not
correct on every seed; the program itself as correct."""

import pytest
import torch

from harness import cell, common

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
SECONDS = {"vox256.video": 3.0, "ffhq1024.crops": 3.0}
CELLS = [w["name"] for w in common.benchmark()["workloads"]]


def _run(name: str, seed: int, device, control: bool):
    w = common.cell(name)
    run = cell.Run(w, common.config(w["config"]), common.traffic(w["traffic"]), seed,
                   device, control=control)
    res = cell.run_cell(run, SECONDS[name], False, 0.0)
    torch.cuda.empty_cache()
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_refused(card, name):
    for seed in SEEDS:
        res = _run(name, seed, card, control=True)
        assert not res["correct"], (seed, res["numbers"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(card, name):
    res = _run(name, SEEDS[0], card, control=False)
    assert res["correct"], res["numbers"]
