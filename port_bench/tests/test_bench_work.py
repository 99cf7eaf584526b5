"""The benchmark's own counts of work, against hand counts at small
shapes."""

import torch
import torch.nn.functional as F

from harness import work


def test_k3_flops_is_three_convolutions_by_hand():
    b, h, w = 2, 4, 4
    hand = sum(2 * b * h * w * cout * cin * 9 for cin, cout in ((256, 128), (128, 64), (64, 64)))
    assert work.k3_flops((b, 256, h, w)) == hand == b * h * w * 811008


def test_k3_flops_matches_the_flop_counter():
    x = torch.randn(1, 256, 4, 4)
    ws = [torch.randn(128, 256, 3, 3), torch.randn(64, 128, 3, 3), torch.randn(64, 64, 3, 3)]

    def block():
        o1 = F.conv2d(x, ws[0], padding=1)
        o2 = F.conv2d(o1, ws[1], padding=1)
        F.conv2d(o2, ws[2], padding=1)

    assert work.count_flops(block) == work.k3_flops(x.shape)


def test_k1_bytes_by_hand():
    # blur: (2, 8, 9, 9) → (2, 8, 8, 8) with 4x4 taps, pad (1, 1), up 1
    assert work.upfirdn2d_out_hw(9, 9, (4, 4), 1, (1, 1)) == (8, 8)
    assert work.k1_bytes((2, 8, 9, 9), (4, 4), 1, (1, 1)) == (2 * 8 * 81 + 2 * 8 * 64) * 4
    # skip upsample: (1, 3, 8, 8) → (1, 3, 16, 16), pad (2, 1), up 2
    assert work.upfirdn2d_out_hw(8, 8, (4, 4), 2, (2, 1)) == (16, 16)
    assert work.k1_bytes((1, 3, 8, 8), (4, 4), 2, (2, 1), 2) == (3 * 64 + 3 * 256) * 2


def test_roofline_takes_the_larger_bound():
    t = 1e-3
    assert abs(work.roofline_pct(495e9, 0.0, t) - 100.0) < 1e-9
    assert abs(work.roofline_pct(0.0, 3.35e9 / 2, t) - 50.0) < 1e-9
    assert work.roofline_pct(1.0, 1.0, 0.0) is None
    assert abs(work.mfu_pct(495e12 * 0.1, 1.0) - 10.0) < 1e-9
