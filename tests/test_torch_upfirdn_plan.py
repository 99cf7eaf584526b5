"""K1's launch plan, on the CPU: what ``ops/upfirdn2d_kernel.py`` builds
around the CUDA kernel (the cached plan, its output shape and gradient
pads, the launch shape) and a replay of the kernel's thread mapping and
index arithmetic (``csrc/upfirdn2d.cu``) held against the plain version.

Plans are made for a CUDA device without a card: a plan only reads the
input's shape, dtype and device. The replay runs the kernel's arithmetic
in float32 numpy, thread by thread, on small planes of eighths; the taps
are dyadic, so every sum is exact in any order and the replay equals the
plain version to the bit.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from stylegan_directions_face_reenactment_tpu_torch.ops import upfirdn2d_kernel as k1
from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
    pti_backward_calls, upfirdn2d_calls)
from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import (
    make_kernel, upfirdn2d, upfirdn2d_output_shape)
from torch_threads import _threads  # noqa: F401

CARD = torch.device("cuda", 0)
TAPS = make_kernel((1, 3, 3, 1), gain=4)


def fake(shape, dtype=torch.float32):
    """What a plan reads of a CUDA tensor."""
    return SimpleNamespace(shape=torch.Size(shape), dtype=dtype, device=CARD)


def _serving_and_pti():
    """(input shape, up, down, pad) of every K1 launch: the serving
    forwards at batch 16 and 1, the PTI step's backwards."""
    calls = [(c.shape, c.up, 1, c.pad) for b in (16, 1) for c in upfirdn2d_calls(batch=b)]
    for c in pti_backward_calls().upfirdn2d:
        oh, ow = upfirdn2d_output_shape(c.shape[2], c.shape[3], (4, 4), up=c.up, pad=c.pad)
        calls.append((c.shape[:2] + (oh, ow), 1, c.up,
                      k1.grad_pad((4, 4), c.up, c.pad, c.shape[2:])))
    return calls


def covered_outputs(plan: k1.K1Plan) -> np.ndarray:
    """How many times the launch of ``plan`` writes each output, as the
    kernel maps threads to outputs: thread (tx, ty, tz) of block (gx, gy, gz)
    writes plane ``gz·bz + tz``, row ``gy·by + ty`` and the four columns from
    ``4·(gx·bx + tx)`` that lie inside the output."""
    p = plan.params
    xs = (np.arange(p.gx * p.bx)[:, None] * 4 + np.arange(4)).ravel()
    ys, zs = np.arange(p.gy * p.by), np.arange(p.gz * p.bz)
    counts = np.zeros((p.planes, p.out_h, p.out_w), np.int64)
    np.add.at(counts, np.ix_(zs[zs < p.planes], ys[ys < p.out_h], xs[xs < p.out_w]), 1)
    return counts


def band_reads_fit(plan: k1.K1Plan) -> bool:
    """Whether the largest band row and column a thread reads (the kernel's
    offsets: ``ty·down + j`` and ``4·tx·down`` plus an 8- or 12-float window
    with up 1; ``(Q + ty) // 2 + (RP + j) // 2`` and ``2·tx + 3`` with up 2)
    lie in the shared band."""
    p = plan.params
    if p.up == 1:
        max_row = (p.by - 1) * p.down + 3
        max_col = 4 * (p.bx - 1) * p.down + (8 if p.down == 1 else 12) - 1
    else:
        max_row = p.by // 2 + 2
        max_col = 2 * (p.bx - 1) + 3
    return max_row < p.rows_in and max_col < p.cols_in


ODD = [((2, 5, 13, 11), 1, 1, (2, 2)), ((2, 5, 13, 11), 2, 1, (1, 2)),
       ((2, 5, 13, 11), 1, 1, (-1, 2)), ((3, 2, 7, 9), 1, 2, (1, 1, 2, 0)),
       ((1, 7, 5, 6), 2, 1, (2, 1, 1, 2)), ((1, 1, 1, 1), 2, 1, (2, 1))]


def test_plan_is_cached_per_key():
    x = fake((1, 3, 16, 16))
    a = k1.plan_for(x, TAPS, 2, 1, (2, 1), "t")
    assert k1.plan_for(x, TAPS, 2, 1, (2, 1), "t") is a
    assert k1.plan_for(fake((1, 3, 16, 16)), TAPS, 2, 1, (2, 1), "t") is a
    assert k1.plan_for(x, TAPS, 2, 1, (1, 1), "t") is not a
    assert k1.plan_for(fake((1, 3, 8, 16)), TAPS, 2, 1, (2, 1), "t") is not a
    assert k1.plan_for(fake((1, 3, 16, 16), torch.bfloat16), TAPS, 2, 1, (2, 1),
                       "t") is not a
    same = make_kernel((1, 3, 3, 1), gain=4)         # the same taps, another tensor
    assert k1.plan_for(x, same, 2, 1, (2, 1), "t") is a           # keyed by the values
    assert k1.plan_for(x, k1.taps_of(same), 2, 1, (2, 1), "t") is a
    other = make_kernel((1, 2, 1), gain=4)
    assert k1.plan_for(x, other, 2, 1, (2, 1), "t") is not a
    with pytest.raises(ValueError, match="CUDA"):
        k1.make_plan((1, 3, 16, 16), torch.float32, torch.device("cpu"), TAPS, 2, 1, (2, 1))
    with pytest.raises(TypeError):
        k1.make_plan((1, 3, 16, 16), torch.float16, CARD, TAPS, 2, 1, (2, 1))


@pytest.mark.parametrize("case", _serving_and_pti() + ODD, ids=str)
def test_plan_shapes_and_coverage(case):
    """The output shape is the plain version's; every output is written by
    exactly one thread; the shared band holds every element a thread
    reads; the launch fits the kernel's limits."""
    shape, up, down, pad = case
    plan = k1.make_plan(shape, torch.float32, CARD, TAPS, up, down, pad)
    oh, ow = upfirdn2d_output_shape(shape[2], shape[3], (4, 4), up=up, down=down, pad=pad)
    assert plan.out_shape == tuple(shape[:2]) + (oh, ow)
    assert (covered_outputs(plan) == 1).all()
    assert band_reads_fit(plan)
    p = plan.params
    assert p.bx * p.by * p.bz <= 256 and p.smem_bytes <= 48 * 1024 and p.cols_in % 4 == 0
    blocks, work = p.gx * p.gy * p.gz, shape[0] * shape[1] * oh * -(-ow // 4)
    assert blocks >= min(k1.SMS, -(-work // 32)) or p.bx * p.by * p.bz == 32


@pytest.mark.parametrize("call", pti_backward_calls().upfirdn2d, ids=lambda c: c.name)
def test_backward_plan_uses_the_gradient_pads(call):
    oh, ow = upfirdn2d_output_shape(call.shape[2], call.shape[3], (4, 4), up=call.up,
                                    pad=call.pad)
    g = fake(call.shape[:2] + (oh, ow))
    plan = k1._bwd_plan(g, TAPS, call.up, call.pad, call.shape)
    assert plan is k1._bwd_plan(g, TAPS, call.up, call.pad, call.shape)
    assert plan.out_shape == tuple(call.shape)
    assert plan.pad == k1.grad_pad((4, 4), call.up, call.pad, call.shape[2:])
    assert (plan.params.up, plan.params.down) == (1, call.up)
    # the backward's taps are the forward's flipped taps, flipped again
    np.testing.assert_array_equal(np.ctypeslib.as_array(plan.params.taps).reshape(4, 4),
                                  TAPS.numpy())


def replay(x: np.ndarray, plan: k1.K1Plan) -> np.ndarray:
    """The kernel, thread by thread, as ``csrc/upfirdn2d.cu`` computes."""
    p = plan.params
    taps = np.ctypeslib.as_array(p.taps).reshape(4, 4)
    planes = x.reshape(-1, p.in_h, p.in_w)
    y = np.full((p.planes, p.out_h, p.out_w), np.nan, np.float32)
    for gz in range(p.gz):
        for gy in range(p.gy):
            for gx in range(p.gx):
                ox_b, oy_b, pl_b = gx * p.bx * 4, gy * p.by, gz * p.bz
                if p.up == 1:
                    base_y, base_x = oy_b * p.down - p.pad_y0, ox_b * p.down - p.pad_x0
                else:
                    base_y, base_x = (oy_b - p.pad_y0) >> 1, (ox_b - p.pad_x0) >> 1
                band = np.zeros((p.bz, p.rows_in, p.cols_in), np.float32)
                for z in range(p.bz):
                    for r in range(p.rows_in):
                        for c in range(p.cols_in):
                            iy, ix = base_y + r, base_x + c
                            if (pl_b + z < p.planes and 0 <= iy < p.in_h
                                    and 0 <= ix < p.in_w):
                                band[z, r, c] = planes[pl_b + z, iy, ix]
                for tz in range(p.bz):
                    for ty in range(p.by):
                        for tx in range(p.bx):
                            plane, oy, ox0 = pl_b + tz, oy_b + ty, ox_b + 4 * tx
                            if plane >= p.planes or oy >= p.out_h or ox0 >= p.out_w:
                                continue
                            sp = band[tz]
                            acc = np.zeros(4, np.float32)
                            for j in range(4):
                                if p.up == 1:
                                    row = sp[ty * p.down + j]
                                    for k in range(4):
                                        for i in range(4):
                                            acc[k] += taps[j, i] * row[(4 * tx + k) * p.down + i]
                                    continue
                                rel = oy - p.pad_y0 - 2 * base_y
                                rp, a, pc = rel & 1, rel >> 1, p.pad_x0 & 1
                                if (rp + j) & 1:
                                    continue
                                row = sp[a + ((rp + j) >> 1)]
                                for k in range(4):
                                    for i in range(4):
                                        if (pc + k + i) & 1:
                                            continue
                                        acc[k] += taps[j, i] * row[2 * tx + ((pc + k + i) >> 1)]
                            n = min(4, p.out_w - ox0)
                            y[plane, oy, ox0:ox0 + n] = acc[:n]
    return y.reshape(plan.out_shape)


@pytest.mark.parametrize("case", [((1, 2, 9, 9), 1, 1, (1, 1)),
                                  ((1, 3, 4, 4), 2, 1, (2, 1)),
                                  ((1, 2, 8, 8), 1, 1, (2, 2)),
                                  ((1, 3, 16, 16), 1, 2, (1, 1))] + ODD[:5], ids=str)
def test_replay_of_the_kernel_matches_plain(case):
    shape, up, down, pad = case
    plan = k1.make_plan(shape, torch.float32, CARD, TAPS, up, down, pad)
    # eighths times dyadic taps: every product and sum is exact in float32,
    # whatever the order, so the replay must equal the plain version bit for bit
    rs = np.random.RandomState(sum(shape))
    x = torch.from_numpy((rs.randint(-64, 65, shape) / 8).astype(np.float32))
    want = upfirdn2d(x, TAPS, up=up, down=down, pad=pad).numpy()
    np.testing.assert_array_equal(replay(x.numpy(), plan), want)
