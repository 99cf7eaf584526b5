"""The port's FAN and its K3 gate against the JAX package on the CPU.

Weights: the port's seeded init with randomized batch-norm statistics,
through ``convert_fan`` and back (``tests/torch_face_zoo.py``). Inputs are
made with numpy from a seed.

Tolerances:
* ConvBlock, float32: rtol 1e-4, atol 1e-4, the bound of the JAX
  package's own fused-vs-XLA test (sums of 2304 products in another order).
* ConvBlock, bf16: rtol 0.05, atol 0.15, the JAX package's bf16 bound
  (both round to bf16 between stages; a last-bit flip there is 1/128
  relative).
* FAN heatmaps: rtol 1e-3, atol 1e-4·max|heatmap| (13 blocks a module,
  two modules, each summing in its own order).
* Peaks and image coordinates: exact; they are computed on the same
  values in the same order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.models.face.fan import (
    conv_block as j_conv_block, fan_forward as j_fan_forward,
    heatmaps_to_landmarks as j_heatmaps_to_landmarks,
    landmarks_to_image_coords as j_landmarks_to_image_coords)
from stylegan_directions_face_reenactment_tpu.ops.fused_conv_block import (
    conv_block_fused as j_conv_block_fused, fused_conv_block_256 as j_fused_conv_block_256)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import convert_fan

from stylegan_directions_face_reenactment_tpu_torch.models.face.fan import (
    ConvBlock, conv_block, fan_forward, heatmaps_to_landmarks,
    landmarks_to_image_coords)
from stylegan_directions_face_reenactment_tpu_torch.ops import fused_conv_block as k3
from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
    fused_conv_block_calls)

from torch_face_zoo import fan_pair, randomize_bn, statics_jit, to_np
from torch_threads import _threads  # noqa: F401


@pytest.fixture(scope="module")
def fans():
    return fan_pair(seed=3, num_modules=2)


@pytest.fixture(scope="module")
def block():
    """One channels-equal 256-channel block: (JAX pytree, port ConvBlock)."""
    p = randomize_bn(ConvBlock(256, 256), 4)
    with torch.no_grad():
        g = torch.Generator().manual_seed(5)
        for c in (p.conv1, p.conv2, p.conv3):
            c.weight.copy_(torch.randn(c.weight.shape, generator=g) * 0.05)
    sd = {f"top_m_0.{k}": v for k, v in p.state_dict().items()}
    j = to_np(convert_fan(_fan_sd_stub(sd), num_modules=1))["modules"][0]["top_m"]
    return j, p


def _fan_sd_stub(sd):
    """A FAN state dict whose only real entries are ``top_m_0``'s: the
    converter reads every key, so the rest are zeros of the right shapes."""
    from stylegan_directions_face_reenactment_tpu_torch.models.face.fan import FAN
    full = {k: torch.zeros_like(v) for k, v in FAN(1).state_dict().items()}
    full.update(sd)
    return full


@pytest.mark.parametrize("hw,dtype", [(8, "float32"), (16, "float32"), (8, "bfloat16")])
def test_conv_block_matches_jax(block, hw, dtype):
    """The port's block (the plain version on the CPU, the kernel's plain
    version through ``fused_conv_block`` too) against the JAX ``conv_block``
    and the JAX Pallas kernel ``conv_block_fused`` in interpret mode."""
    jp, p = block
    x = np.random.RandomState(hw).randn(2, hw, hw, 256).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want_xla = np.asarray(j_conv_block(jp, jx).astype(jnp.float32))
    want_pallas = np.asarray(j_conv_block_fused(jp, jx).astype(jnp.float32))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    with torch.no_grad():
        got = conv_block(p, tx)
        got_k3 = k3.fused_conv_block(tx, k3.block_args(p, tx.dtype))
    torch.testing.assert_close(got_k3, got, rtol=0, atol=0)
    got = got.float().permute(0, 2, 3, 1).numpy()
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=0.05, atol=0.15)
    np.testing.assert_allclose(got, want_xla, **tol)
    np.testing.assert_allclose(got, want_pallas, **tol)


def test_fused_conv_block_256_matches_jax(block):
    """K3's entry on the JAX package's operands (each stage's fold and
    weight) against the JAX ``fused_conv_block_256``, the Pallas kernel in
    interpret mode: the port takes OIHW weights and NCHW x where the JAX
    function takes (9, cin, cout) and NHWC."""
    from stylegan_directions_face_reenactment_tpu_torch.models.nn import fold_bn
    _, p = block
    x = np.random.RandomState(9).randn(2, 8, 8, 256).astype(np.float32)
    with torch.no_grad():
        folds = [fold_bn(bn, torch.float32) for bn in (p.bn1, p.bn2, p.bn3)]
    ws = [c.weight.detach() for c in (p.conv1, p.conv2, p.conv3)]
    j_args = [a for (i, f), w in zip(folds, ws) for a in (
        jnp.asarray(i.numpy()[None]), jnp.asarray(f.numpy()[None]),
        jnp.asarray(w.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0]).numpy()))]
    want = np.asarray(j_fused_conv_block_256(jnp.asarray(x), *j_args))
    with torch.no_grad():
        got = k3.fused_conv_block_256(torch.from_numpy(x).permute(0, 3, 1, 2),
                                      *[a for (i, f), w in zip(folds, ws) for a in (i, f, w)])
        torch.testing.assert_close(got, conv_block(p, torch.from_numpy(x).permute(0, 3, 1, 2)),
                                   rtol=0, atol=0)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-4, atol=1e-4)


def test_fan_forward_matches_jax(fans):
    jf, pf = fans
    x = np.random.RandomState(6).rand(2, 128, 128, 3).astype(np.float32)
    want = statics_jit(j_fan_forward, jf)(jnp.asarray(x))
    with torch.no_grad():
        got = fan_forward(pf, torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, 32, 32, 68)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4 * np.abs(w).max())


def test_heatmaps_to_landmarks_ties_and_borders():
    rs = np.random.RandomState(7)
    hm = rs.rand(3, 64, 64, 68).astype(np.float32)
    hm[0, 10, 20, 0] = hm[0, 10, 40, 0] = hm[0, 30, 5, 0] = 2.0   # ties: row-major first
    hm[0, 0, 33, 1] = 2.0                                          # top border
    hm[0, 63, 63, 2] = 2.0                                         # corner
    hm[0, 17, 0, 3] = 2.0                                          # left border
    hm[1, 5, 6, 4] = 2.0
    hm[1, 5, 7, 4] = hm[1, 5, 5, 4] = 1.5                          # equal neighbours: no shift
    hm[2] = 0.0                                                    # all tied: index 0
    hm[2, :, :, 5] = np.round(rs.rand(64, 64) * 4) / 4             # many exact ties
    want = np.asarray(j_heatmaps_to_landmarks(jnp.asarray(hm)))
    got = heatmaps_to_landmarks(torch.from_numpy(hm)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[0, 0] - [20.5, 10.5]).max() == 0.25   # first of the ties
    np.testing.assert_array_equal(got[0, 1:4], [[33.5, 0.5], [63.5, 63.5], [0.5, 17.5]])
    assert got[1, 4, 0] == 6.5                                   # equal neighbours
    np.testing.assert_array_equal(got[2, 0], [0.5, 0.5])


@pytest.mark.parametrize("truncate", [True, False])
def test_landmarks_to_image_coords_matches_jax(truncate):
    rs = np.random.RandomState(8)
    pts = (rs.rand(4, 68, 2) * 64).astype(np.float32)
    center = (rs.rand(4, 2) * 500 - 50).astype(np.float32)
    scale = (rs.rand(4) * 3 + 0.2).astype(np.float32)
    want = np.asarray(j_landmarks_to_image_coords(
        jnp.asarray(pts), jnp.asarray(center), jnp.asarray(scale), truncate=truncate))
    got = landmarks_to_image_coords(torch.from_numpy(pts), torch.from_numpy(center),
                                    torch.from_numpy(scale), truncate=truncate).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    if truncate:
        np.testing.assert_array_equal(got, np.trunc(got))


def test_k3_gate():
    """Channels-equal 256-channel blocks take the kernel for CUDA tensors
    only, so on the CPU every block takes the plain version and nothing
    launches; other blocks never take it; the launcher refuses a CPU
    tensor."""
    eq, down = ConvBlock(256, 256), ConvBlock(128, 256)
    x = torch.zeros(1, 256, 8, 8)
    assert not k3.fused_convblock_enabled(eq, x)
    assert not k3.fused_convblock_enabled(down, torch.zeros(1, 128, 8, 8))
    assert not k3.fused_convblock_enabled(ConvBlock(128, 128), torch.zeros(1, 128, 8, 8))
    meta = torch.empty(1, 256, 8, 8, device="meta")
    assert not k3.fused_convblock_enabled(eq, meta)
    before = k3.fused_conv_block_cuda.launches
    with torch.no_grad():
        conv_block(eq, x)
    assert k3.fused_conv_block_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        k3.fused_conv_block_cuda(x, k3.block_args(eq, x.dtype))
    with pytest.raises(ValueError, match="cuda or cpu"):
        k3.fused_conv_block(meta, k3.block_args(eq, x.dtype))


def test_k3_calls_of_a_fan_pass():
    calls = fused_conv_block_calls(16)
    assert len(calls) == 56
    sizes = sorted({c[2] for c in calls})
    assert sizes == [4, 8, 16, 32, 64]
    assert sum(c[2] == 64 for c in calls) == 8 and all(c[:2] == (16, 256) for c in calls)


def test_block_args_follow_weight_changes():
    """The kernel's folded arguments are kept between calls and rebuilt
    when a statistic or weight changes in place."""
    p = ConvBlock(256, 256)
    with torch.no_grad():
        a = k3.block_args(p, torch.float32)
        assert k3.block_args(p, torch.float32) is a
        p.bn2.running_var.fill_(4.0)
        b = k3.block_args(p, torch.float32)
    assert b is not a
    torch.testing.assert_close(b.inv[1], torch.full((128,), (4.0 + 1e-5) ** -0.5),
                               rtol=1e-6, atol=0)
    assert b.wk[0].shape == (9, 8, 2, 128, 32) and b.wk[0].is_contiguous()


def test_block_args_kept_for_a_frozen_block_with_grad_on():
    """With grad on, a block whose parameters require a gradient gets fresh
    args each call (so the gradient reaches them); a frozen block (the
    trainer's FAN) keeps its args, so its K3 calls fold and pack nothing
    anew."""
    p = ConvBlock(256, 256)
    assert k3.block_args(p, torch.float32) is not k3.block_args(p, torch.float32)
    p.requires_grad_(False)
    a = k3.block_args(p, torch.float32)
    assert k3.block_args(p, torch.float32) is a
    with torch.no_grad():
        assert k3.block_args(p, torch.float32) is a


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_program_k3_args_are_block_args(dtype):
    """A reenactment program's K3 constants (``ReenactProgram.block_args``)
    are, tensor for tensor, the K3Args ``block_args`` makes for each block of
    a seeded 4-module FAN, and its blocks are exactly those ``k3_takes``."""
    from stylegan_directions_face_reenactment_tpu_torch.pipeline.reenactment import (
        ReenactProgram)
    from stylegan_directions_face_reenactment_tpu_torch.weights import init_fan
    fan = randomize_bn(init_fan(6, 4, device="cpu"), 7)
    prog = ReenactProgram(None, None, None, None, fan, None, None, truncation=0.7,
                          num_layers_shift=8, compute_dtype=dtype,
                          return_target_params=False, reuse_landmarks=False)
    got = prog.block_args()
    assert list(got) == [m for m in fan.modules()
                         if isinstance(m, ConvBlock) and k3.k3_takes(m)]
    assert len(got) == 56
    with torch.no_grad():
        for blk, args in got.items():
            want = k3.block_args(blk, dtype)
            for g_group, w_group in zip(args, want):
                assert all(torch.equal(g, w) for g, w in zip(g_group, w_group))


def test_state_dict_keeps_the_reference_key_layout(fans):
    """The port's FAN state dict goes through ``convert_fan`` and gives back
    the pytree it was made from; the last module has no bl/al."""
    jf, pf = fans
    sd = pf.state_dict()
    assert "bl0.weight" in sd and "bl1.weight" not in sd and "al1.weight" not in sd
    assert "m1.b2_plus_1.conv3.weight" in sd and "conv4.downsample.2.weight" in sd
    back = to_np(convert_fan(sd, num_modules=2))
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jf):
        if isinstance(leaf, np.ndarray):
            np.testing.assert_array_equal(np.asarray(flat[path]), leaf)
            n += 1
    assert n > 500


def test_kernel_weight_layouts():
    """K3's packed weights hold w[co, ci, ky, kx] as its TF32 hi and lo parts
    at (3·ky + kx, ci // 32, 0 and 1, co, ci % 32) in float32 and at (3·ky +
    kx, ci // 64, co, ci % 64) in bf16."""
    w = torch.randn(64, 128, 3, 3)
    f = k3.kernel_weight(w)
    assert f.shape == (9, 4, 2, 64, 32) and f.is_contiguous()
    for co, ci, ky, kx in [(5, 37, 2, 1), (63, 127, 0, 0), (0, 64, 1, 2)]:
        hi, lo = f[3 * ky + kx, ci // 32, :, co, ci % 32]
        assert hi == k3.tf32_split(w[co, ci, ky, kx])[0]
        assert abs(float(hi) + float(lo) - float(w[co, ci, ky, kx])) <= 2 ** -21 * abs(
            float(w[co, ci, ky, kx]))
    wb = w.bfloat16()
    b = k3.kernel_weight(wb)
    assert b.shape == (9, 2, 64, 64) and b.is_contiguous()
    for co, ci, ky, kx in [(5, 37, 2, 1), (63, 127, 0, 0), (0, 64, 1, 2)]:
        assert b[3 * ky + kx, ci // 64, co, ci % 64] == wb[co, ci, ky, kx]
