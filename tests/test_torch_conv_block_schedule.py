"""K3's partition of the work, on the CPU: what surrounds the CUDA kernel
of ``ops/fused_conv_block.py`` (the schedule table, the weight packing,
the scratch layout, the cached launch plan), and a torch emulation of the kernel's arithmetic held
against the plain version and the JAX package's block.

The emulation follows ``csrc/fused_conv_block.cu``: the first stage's
activation made channels-innermost (NHWC) by a prologue; each stage a GEMM
over the pixels of all images whose K steps are (tap, channel chunk)
slices read from the packed weights (bf16 tap by tap, float32 chunk by
chunk); the K steps of a split summed in f32
(in float32 as three TF32 products of the activation's and the weight's hi
and lo parts, the big and the small products summed apart and added at the
split's end), the splits added in split order; the epilogue rounding the
sum to the activation dtype, adding x for ``out`` and folding the next
stage's activation from the rounded sum.

Tolerances: against the plain version, float32 1e-5·max(1, max|plain|)
(sums of up to 2304 products in another order), bf16 1e-2·max(1,
max|plain|) (one bf16 rounding, 2^-8, on either side), the card tests'
bounds. Against the JAX package's XLA block (its plain reference on the
CPU, at batch 3): float32 the same; bf16 rtol 0.05, atol 0.15, the JAX package's own
bf16 bound (``tests/test_torch_fan.py``): JAX rounds its batch norm to bf16
in other places than the fold does.
"""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from stylegan_directions_face_reenactment_tpu.models.face.fan import (
    conv_block as j_conv_block)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import convert_fan

from stylegan_directions_face_reenactment_tpu_torch.models.face.fan import FAN, ConvBlock
from stylegan_directions_face_reenactment_tpu_torch.ops import fused_conv_block as k3
from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
    fused_conv_block_calls)

from torch_face_zoo import randomize_bn, to_np
from torch_threads import _threads  # noqa: F401

CARD = torch.device("cuda", 0)


@pytest.fixture(scope="module")
def block():
    """One channels-equal 256-channel block: (JAX pytree, port ConvBlock)."""
    p = randomize_bn(ConvBlock(256, 256), 11)
    with torch.no_grad():
        g = torch.Generator().manual_seed(12)
        for c in (p.conv1, p.conv2, p.conv3):
            c.weight.copy_(torch.randn(c.weight.shape, generator=g) * 0.05)
    full = {k: torch.zeros_like(v) for k, v in FAN(1).state_dict().items()}
    full.update({f"top_m_0.{k}": v for k, v in p.state_dict().items()})
    return to_np(convert_fan(full, num_modules=1))["modules"][0]["top_m"], p


_j_block = jax.jit(j_conv_block)      # one compile a shape, not one an op


def _activate(v, inv, off):
    return torch.clamp_min(v * inv + off, 0)


def emulate(x: torch.Tensor, args: k3.K3Args) -> torch.Tensor:
    """K3's arithmetic in the kernel's partition (see the module note)."""
    dtype = x.dtype
    b, _, h, w = x.shape
    m = b * h * w
    sched = k3.schedule(b, h, w, dtype)
    kc = k3.k_step_channels(dtype)
    act = _activate(x.permute(0, 2, 3, 1).reshape(m, 256), args.inv[0], args.off[0])
    outs = []
    for st, (cin, cout) in enumerate(k3.STAGES):
        wk, nchunk = args.wk[st], cin // kc
        ksteps = 9 * nchunk
        padded = F.pad(act.reshape(b, h, w, cin), (0, 0, 1, 1, 1, 1))
        a_hi, a_lo = k3.tf32_split(padded) if dtype == torch.float32 else (padded, None)
        parts = []
        for s0 in range(0, ksteps, sched.kchunk[st]):
            big, small = torch.zeros(m, cout), torch.zeros(m, cout)
            for step in range(s0, min(ksteps, s0 + sched.kchunk[st])):
                if dtype == torch.bfloat16:
                    tap, cc = divmod(step, nchunk)
                else:
                    cc, tap = divmod(step, 9)
                ky, kx = divmod(tap, 3)

                def rows(t):
                    return t[:, ky:ky + h, kx:kx + w, cc * kc:(cc + 1) * kc].reshape(m, kc)
                if dtype == torch.bfloat16:
                    big = big + rows(a_hi).float() @ wk[tap, cc].float().t()
                else:
                    w_hi, w_lo = wk[tap, cc, 0].t(), wk[tap, cc, 1].t()
                    big = big + rows(a_hi) @ w_hi
                    small = small + rows(a_hi) @ w_lo + rows(a_lo) @ w_hi
            parts.append(big + small)
        assert len(parts) == sched.splits[st]
        total = parts[0]
        for p_ in parts[1:]:       # the split-K pass: in split order
            total = total + p_
        o = total.to(dtype)
        outs.append(o)
        if st < 2:
            act = _activate(o, args.inv[st + 1], args.off[st + 1])
    o = torch.cat(outs, dim=1).reshape(b, h, w, 256).permute(0, 3, 1, 2)
    return o + x


def _limit(want, dtype):
    scale = max(1.0, float(want.float().abs().max()))
    return (1e-5 if dtype == torch.float32 else 1e-2) * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("hw", [(4, 4), (8, 8), (16, 16), (5, 7)], ids=str)
def test_partition_matches_plain_and_jax(block, hw, batch, dtype):
    jp, p = block
    x = np.random.RandomState(hw[0] * 10 + batch).randn(batch, hw[0], hw[1], 256)
    x = x.astype(np.float32)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(tdt)
    with torch.no_grad():
        args = k3.block_args(p, tdt)
        got = emulate(tx, args)
        want = k3.fused_conv_block_plain(tx, args)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    assert err <= _limit(want, tdt), err
    if batch == 1:          # the JAX block once a size and dtype: its compiles cost
        return
    j = np.asarray(_j_block(jp, jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    got_nhwc = got.float().permute(0, 2, 3, 1).numpy()
    if tdt == torch.float32:
        assert float(np.abs(got_nhwc - j).max()) <= _limit(want, tdt)
    else:
        np.testing.assert_allclose(got_nhwc, j, rtol=0.05, atol=0.15)


def _ksteps(cin, dtype):
    return 9 * cin // k3.k_step_channels(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("batch", [16, 1])
def test_schedule_table_covers_the_main_path(batch, dtype):
    """Every K3 shape of a FAN pass gets a schedule: the splits cover the K
    steps exactly, a stage short of a full wave is split until it has a
    block for each SM, a block for each K step or the most splits the
    table allows, and the workspace holds the largest split stage's
    partials."""
    for shape in sorted(set(fused_conv_block_calls(batch))):
        b, _, h, w = shape
        s = k3.schedule(b, h, w, dtype)
        assert s is k3.schedule(b, h, w, dtype)      # a table: made once a shape
        m = b * h * w
        m_tiles = -(-m // k3.TILE_M)
        ws = 0
        for st, (cin, cout) in enumerate(k3.STAGES):
            ksteps, chunk, n = _ksteps(cin, dtype), s.kchunk[st], s.splits[st]
            tiles = m_tiles         # a tile spans the stage's output channels
            assert 1 <= chunk <= ksteps and n == -(-ksteps // chunk)
            assert (n - 1) * chunk < ksteps <= n * chunk
            assert s.blocks[st] == tiles * n
            if tiles >= k3.full_wave(dtype):
                assert n == 1
            else:
                assert n <= k3.MAX_SPLITS and (s.blocks[st] >= k3.SMS or n == ksteps
                                               or n * chunk - chunk < ksteps <= k3.MAX_SPLITS
                                               * chunk), (shape, st, s)
                ws = max(ws, n * m * cout) if n > 1 else ws
        assert s.workspace == ws
    if batch == 16:   # the small maps split, the large ones do not
        assert k3.schedule(16, 64, 64, dtype).splits == (1, 1, 1)
        assert all(n > 1 for n in k3.schedule(16, 4, 4, dtype).splits)


def test_scratch_layout():
    for b, h, w, dtype in [(16, 4, 4, torch.bfloat16), (1, 5, 7, torch.float32),
                           (16, 64, 64, torch.float32)]:
        act_b, ws, total = k3.scratch_layout(b, h, w, dtype)
        es = 2 if dtype == torch.bfloat16 else 4
        m = b * h * w
        assert act_b % 256 == 0 and ws % 256 == 0
        assert act_b >= m * 256 * es and ws - act_b >= m * 128 * es
        assert total - ws == 4 * k3.schedule(b, h, w, dtype).workspace


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_launch_plan_is_made_once_per_shape(monkeypatch, dtype):
    """``plan_for`` makes K3's plan (entry point, scratch layout, K steps a
    block) on the first call of an input shape, dtype and device and hands
    it back after; another shape or dtype makes another, and
    ``fused_conv_block_cuda.plan_misses`` counts what was made. Plans are
    made for a CUDA device without a card: a plan reads only the input's
    shape, dtype and device."""
    lib = SimpleNamespace(fused_conv_block_f32=object(), fused_conv_block_bf16=object())
    monkeypatch.setattr(k3, "load_library", lambda: lib)
    monkeypatch.setattr(k3, "_plans", {})
    monkeypatch.setattr(k3.fused_conv_block_cuda, "plan_misses", 0)
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32

    def fake(shape, dt=dtype):
        return SimpleNamespace(shape=torch.Size(shape), dtype=dt, device=CARD)
    a = k3.plan_for(fake((16, 256, 64, 64)))
    assert a.fn is getattr(lib, k3._ENTRY[dtype])
    assert a.layout == k3.scratch_layout(16, 64, 64, dtype)
    assert a.kchunk == k3.schedule(16, 64, 64, dtype).kchunk
    assert k3.plan_for(fake((16, 256, 64, 64))) is a
    assert k3.fused_conv_block_cuda.plan_misses == 1
    b = k3.plan_for(fake((16, 256, 4, 4)))
    assert b is not a and b.kchunk == k3.schedule(16, 4, 4, dtype).kchunk
    assert k3.plan_for(fake((16, 256, 64, 64), other)) is not a
    assert k3.plan_for(fake((16, 256, 4, 4))) is b
    assert k3.fused_conv_block_cuda.plan_misses == 3 and len(k3._plans) == 3


def test_f32_packing_is_a_tf32_hi_lo_pair():
    """A float32 K step (tap, 32-channel chunk) reads one contiguous (2,
    cout, 32) slab: the TF32 hi part of w[co, 32·cc : 32·cc + 32, ky, kx] in
    row co, its lo part in row cout + co; hi has its 13 low mantissa bits
    zero, lo is TF32-rounded, and hi + lo is w within 2^-21·|w|."""
    w = torch.randn(64, 128, 3, 3, generator=torch.Generator().manual_seed(3))
    w[0, 0] = torch.tensor([[0.0, -1.0, 3e-30], [1 + 2 ** -11, -(1 + 3 * 2 ** -11), 7.0],
                            [2 ** -20, 1e-3, -5.5e4]])
    pk = k3.kernel_weight(w)
    assert pk.shape == k3._kernel_weight_shape(128, 64, torch.float32) == (9, 4, 2, 64, 32)
    assert pk.is_contiguous() and pk.dtype == torch.float32
    hi, lo = pk[:, :, 0], pk[:, :, 1]
    low13 = (1 << 13) - 1
    assert not (hi.view(torch.int32) & low13).any()
    assert not (lo.view(torch.int32) & low13).any()
    for tap in (0, 4, 8):
        for cc in (0, 3):
            ky, kx = divmod(tap, 3)
            want = w[:, 32 * cc:32 * cc + 32, ky, kx]
            got = (hi[tap, cc].double() + lo[tap, cc].double())
            assert bool(((got - want.double()).abs() <= 2.0 ** -21 * want.double().abs()).all())
    # ties round away from zero, as cvt.rna.tf32.f32 does
    assert float(hi[3, 0, 0, 0]) == 1 + 2 ** -10 and float(lo[3, 0, 0, 0]) == -(2 ** -11)
    assert float(hi[4, 0, 0, 0]) == -(1 + 2 ** -9) and float(lo[4, 0, 0, 0]) == 2 ** -11
    assert float(hi[1, 0, 0, 0]) == -1.0 and float(lo[1, 0, 0, 0]) == 0.0


def test_bf16_packing_is_one_slab_a_k_step():
    """A bf16 K step (tap, 64-channel chunk) reads one contiguous
    (cout, 64) slab: row co holds w[co, 64·cc : 64·cc + 64, ky, kx]."""
    w = torch.randn(64, 128, 3, 3).bfloat16()
    pk = k3.kernel_weight(w)
    assert pk.shape == (9, 2, 64, 64) and pk.is_contiguous()
    for tap in (0, 4, 8):
        for cc in (0, 1):
            ky, kx = divmod(tap, 3)
            assert torch.equal(pk[tap, cc], w[:, 64 * cc:64 * cc + 64, ky, kx])
