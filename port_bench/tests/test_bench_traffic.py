"""The one generator of inputs: the same seed gives the same inputs, other
seeds other places and textures at the same sizes."""

import pytest
import torch

from harness import common, traffic

SEEDS = (0, 2**31 + 5, 2**32 + 17)


@pytest.mark.parametrize("ground", [True, False], ids=["grey", "black"])
def test_frames_deterministic_in_seed(ground):
    tr = dict(common.traffic("video"), frame_hw=[120, 400], patch=32, margins=[10, 10, 20, 20])
    if not ground:
        del tr["ground_cells"]
    for seed in SEEDS:
        a, b = traffic.frames(tr, seed, 3, "cpu"), traffic.frames(tr, seed, 3, "cpu")
        assert a.dtype == torch.uint8 and a.shape == (3, 120, 400, 3)
        assert torch.equal(a, b)
    assert not torch.equal(traffic.frames(tr, SEEDS[0], 3, "cpu"),
                           traffic.frames(tr, SEEDS[1], 3, "cpu"))


def test_frames_keep_the_patch_inside_the_margins():
    tr = dict(common.traffic("video"), frame_hw=[120, 400], patch=32, margins=[10, 20, 30, 40])
    f = traffic.frames(tr, 7, 16, "cpu")
    colour = f.amax(dim=-1) != f.amin(dim=-1)          # the ground is grey
    rows = colour.any(dim=2).nonzero()[:, 1]
    cols = colour.any(dim=1).nonzero()[:, 1]
    assert rows.min() >= 10 and rows.max() < 120 - 20
    assert cols.min() >= 30 and cols.max() < 400 - 40


def test_crops_deterministic_and_8_bit():
    tr = dict(common.traffic("crops"), crop=64, patch=64, jitter=0)
    for seed in SEEDS:
        a, b = traffic.crops(tr, seed, 2, "cpu"), traffic.crops(tr, seed, 2, "cpu")
        assert torch.equal(a, b) and a.shape == (2, 64, 64, 3)
        u = (a + 1.0) * 127.5
        assert torch.allclose(u, u.round(), atol=1e-3) and a.min() >= -1 and a.max() <= 1
    assert not torch.equal(traffic.crops(tr, 1, 2, "cpu"), traffic.crops(tr, 2, 2, "cpu"))


def test_weights_deterministic_in_seed():
    from harness import nets
    cfg = common.config("vox256")
    a = nets.reference_nets(cfg, ["a", "sfd"], 2**31 + 3, torch.device("cpu"))
    b = nets.reference_nets(cfg, ["a", "sfd"], 2**31 + 3, torch.device("cpu"))
    c = nets.reference_nets(cfg, ["a"], 2**31 + 4, torch.device("cpu"))
    for k, v in a["sfd"].state_dict().items():
        assert torch.equal(v, b["sfd"].state_dict()[k]), k
    assert not torch.equal(a["a"].linear.weight, c["a"].linear.weight)
    assert float(a["sfd"].conv3_3_norm_mbox_conf.bias[3]) == -10.0
