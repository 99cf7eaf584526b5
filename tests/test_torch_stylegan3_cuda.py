"""K4 (``csrc/filtered_lrelu.cu``) against its plain version on the card,
at every layer shape of the published StyleGAN3-T at 1024² (the layer
table of ``models/stylegan3.py``, a batch of 2; per-plane input and output
scales on every other layer), in float32 and bf16; each instantiation
zero-padded to 24 taps (every (up, down) pair) at a small shape; L10-L13
at the chunk's 16 frames with scales that differ plane by plane, and a
frame count whose planes the plan's walk does not divide; K4's prefetch
counter over a StyleGAN3-T chunk against its plans; and the StyleGAN3
synthesis with K4 against the same synthesis through the plain version.
K4 on an NHWC (channels-last) batch against K4 on the NCHW batch, bit for
bit, at every published layer in both dtypes and at L10-L13 at a chunk of
16 at the synthesis' padded channel counts; and a profiled StyleGAN3-T
synthesis at 1024², whose every K4 launch takes channels-last and whose
convolutions launch no layout transpose or padding copy.
``chip_smoke.py`` [k4] holds every published shape at the chunk of 16 the
reenactment path runs.

These need a CUDA card and nvcc; they are marked ``cuda`` and skip
elsewhere (the fixture decides). Run them on the card with:

    python -m pytest tests/test_torch_stylegan3_cuda.py -m cuda -q --noconftest

Tolerances: NHWC against NCHW none (the same filter core on the same
values); float32 2e-5·max(1, max|plain|): the kernel sums each 1-D pass
in the plain version's tap order but the plain version's depthwise
convolutions (cuDNN) may not, through two chained FIRs of up to 24 taps;
bf16 1e-2·max(1, max|plain|): both sum in float32 from the same bf16 input
and round once, so one bf16 rounding (2^-8) on either side. The synthesis,
2e-4·max|plain| in float32: the layers' differences pass through 14 more
layers and their demodulation.
"""

import pytest
import torch

from stylegan_directions_face_reenactment_tpu_torch.models import stylegan3 as sg3
from stylegan_directions_face_reenactment_tpu_torch.ops import filtered_lrelu as k4

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layers():
    """(name, layer) of the published generator, built on the CPU once."""
    g = sg3.Generator()
    return list(zip(g.layer_names, g.layers()))


LAYERS = _layers()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("idx", range(len(LAYERS)), ids=[n for n, _ in LAYERS])
def test_k4_matches_plain_at_published_layer(card, idx, dtype):
    name, m = LAYERS[idx]
    gen = torch.Generator(device=card).manual_seed(idx)
    conv_hw = m.in_size + m.conv_kernel - 1
    x = (torch.randn(2, m.out_channels, conv_hw, conv_hw, generator=gen, device=card) * 3
         ).to(dtype)
    b = torch.randn(m.out_channels, generator=gen, device=card)
    gain, slope = (0.25, 1.0) if m.is_torgb else (2 ** 0.5, 0.2)
    clamp = 64.0 if m.is_torgb else 256.0 if idx % 2 else 1.0
    # the demodulation and the next layer's styles on every other layer
    scales = {} if idx % 2 else dict(
        in_scale=torch.rand(2, m.out_channels, generator=gen, device=card) + 0.5,
        out_scale=torch.rand(2, m.out_channels, generator=gen, device=card) + 0.5)
    before = k4.filtered_lrelu_cuda.launches
    got = k4.filtered_lrelu(x, m.up_taps, m.down_taps, b, m.up, m.down, m.padding, gain,
                            slope, clamp, **scales)
    torch.cuda.synchronize()
    assert k4.filtered_lrelu_cuda.launches == before + 1
    want = k4.filtered_lrelu_plain(x, m.up_taps, m.down_taps, b, m.up, m.down, m.padding,
                                   gain, slope, clamp, **scales)
    assert got.shape == (2, m.out_channels, m.out_size, m.out_size) == want.shape
    assert got.dtype == dtype
    scale = max(1.0, want.float().abs().max().item())
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, (name, err, scale)


# (up, down, taps of fu, taps of fd), planes, input size, pad: every (up,
# down) pair at tap counts no published layer has, so each runs the
# kernel's instantiation zero-padded to 24 taps
GENERIC = (((1, 1, 5, 7), 5, 37, (3, 2, 3, 2)), ((1, 2, 3, 12), 6, 45, (5, 6, 5, 6)),
           ((2, 1, 12, 5), 7, 29, (7, 6, 7, 6)), ((2, 2, 8, 24), 5, 41, (12, 11, 12, 11)),
           ((4, 1, 24, 3), 6, 23, (13, 12, 13, 12)), ((4, 2, 16, 10), 7, 33, (14, 11, -3, 9)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", GENERIC, ids=[f"up{c[0][0]}_down{c[0][1]}" for c in GENERIC])
def test_k4_generic_instantiation_matches_plain(card, case, dtype):
    (up, down, ku, kd), planes, hw, pad = case
    assert k4.instantiated_taps(up, down, ku, kd) == (24 // up, 24)
    gen = torch.Generator(device=card).manual_seed(hw)
    x = (torch.randn(2, planes, hw, hw + 3, generator=gen, device=card) * 3).to(dtype)
    fu = torch.rand(ku, generator=gen, device=card).cpu() + 0.1
    fd = torch.rand(kd, generator=gen, device=card).cpu() + 0.1
    b = torch.randn(planes, generator=gen, device=card)
    scales = dict(in_scale=torch.rand(2, planes, generator=gen, device=card) + 0.5,
                  out_scale=torch.rand(2, planes, generator=gen, device=card) + 0.5)
    args = (fu / fu.sum(), fd / fd.sum(), b, up, down, pad, 2 ** 0.5, 0.2, 4.0)
    before = k4.filtered_lrelu_cuda.launches
    got = k4.filtered_lrelu(x, *args, **scales)
    torch.cuda.synchronize()
    assert k4.filtered_lrelu_cuda.launches == before + 1
    want = k4.filtered_lrelu_plain(x, *args, **scales)
    assert got.shape == want.shape and got.dtype == dtype
    scale = max(1.0, want.float().abs().max().item())
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


def _k4_both_layouts(x, args, scales):
    """K4 on ``x`` NCHW and on the same values channels-last: (NCHW output,
    NHWC output), one launch each, the second counted as NHWC."""
    before = (k4.filtered_lrelu_cuda.launches, k4.filtered_lrelu_cuda.nhwc_launches)
    want = k4.filtered_lrelu(x, *args, **scales)
    got = k4.filtered_lrelu(x.contiguous(memory_format=torch.channels_last), *args, **scales)
    torch.cuda.synchronize()
    assert (k4.filtered_lrelu_cuda.launches, k4.filtered_lrelu_cuda.nhwc_launches) == (
        before[0] + 2, before[1] + 1)
    assert want.is_contiguous() and k4.is_nhwc(got)
    return want, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("idx", range(len(LAYERS)), ids=[n for n, _ in LAYERS])
def test_k4_channels_last_is_bit_equal_to_nchw(card, idx, dtype):
    """Every published layer at its published channel count, 2 frames: each
    sample's channels walked in runs of whole groups, the last group short
    where the count is odd (323, 203, 81, 51, 3)."""
    name, m = LAYERS[idx]
    gen = torch.Generator(device=card).manual_seed(50 + idx)
    conv_hw = m.in_size + m.conv_kernel - 1
    x = (torch.randn(2, m.out_channels, conv_hw, conv_hw, generator=gen, device=card) * 3
         ).to(dtype)
    b = torch.randn(m.out_channels, generator=gen, device=card)
    gain, slope = (0.25, 1.0) if m.is_torgb else (2 ** 0.5, 0.2)
    clamp = 64.0 if m.is_torgb else 256.0 if idx % 2 else 1.0
    args = (m.up_taps, m.down_taps, b, m.up, m.down, m.padding, gain, slope, clamp)
    want, got = _k4_both_layouts(x, args, _distinct_scales(2, m.out_channels, card))
    assert torch.equal(got, want), name


def _plain_by_frames(x, args, scales, frames=4):
    """The plain version a few frames a call (the upsampled plane of a chunk
    of 16 at L10 alone is 23.7 GB)."""
    return torch.cat([k4.filtered_lrelu_plain(
        x[i:i + frames], *args, **{k: v[i:i + frames] for k, v in scales.items()})
        for i in range(0, x.shape[0], frames)])


def _distinct_scales(n, c, device):
    """Per-plane input and output scales, each plane's unlike its
    neighbours', so that a plane read with another's scales shows."""
    i = torch.arange(n * c, device=device, dtype=torch.float32).view(n, c)
    return dict(in_scale=0.5 + (i % 97) / 97, out_scale=1.5 - (i % 89) / 89)


def _check_against_plain(m, idx, x, gen, dtype, scales):
    b = torch.randn(m.out_channels, generator=gen, device=x.device)
    gain, slope = (0.25, 1.0) if m.is_torgb else (2 ** 0.5, 0.2)
    clamp = 64.0 if m.is_torgb else 256.0 if idx % 2 else 1.0
    args = (m.up_taps, m.down_taps, b, m.up, m.down, m.padding, gain, slope, clamp)
    got = k4.filtered_lrelu(x, *args, **scales)
    torch.cuda.synchronize()
    want = _plain_by_frames(x, args, scales)
    assert got.shape == want.shape and got.dtype == dtype
    scale = max(1.0, want.float().abs().max().item())
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, (err, scale)


HIRES = [i for i, (n, _) in enumerate(LAYERS) if n.split("_")[0] in ("L10", "L11", "L12", "L13")]
# L10-L13 and every other layer whose channels the synthesis pads (L7, L8)
PADDED_HIRES = sorted(set(HIRES) | {i for i, (_, m) in enumerate(LAYERS)
                                    if m.out_padded != m.out_channels})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("idx", HIRES, ids=[LAYERS[i][0] for i in HIRES])
def test_k4_matches_plain_at_a_chunk_of_16(card, idx, dtype):
    """L10-L13 at the chunk's 16 frames (1296, 816, 512 and 512 planes),
    each plane with its own scales: the plane walk as the reenactment path
    runs it."""
    _, m = LAYERS[idx]
    gen = torch.Generator(device=card).manual_seed(100 + idx)
    conv_hw = m.in_size + m.conv_kernel - 1
    x = (torch.randn(16, m.out_channels, conv_hw, conv_hw, generator=gen, device=card) * 3
         ).to(dtype)
    plan = k4.plan_for(x, k4._taps(m.up_taps), k4._taps(m.down_taps), m.up, m.down,
                       k4.normalize_pad(m.padding), 2 ** 0.5, 0.2, 1.0)
    assert plan.params.pz > 1
    _check_against_plain(m, idx, x, gen, dtype, _distinct_scales(16, m.out_channels, card))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("idx", PADDED_HIRES, ids=[LAYERS[i][0] for i in PADDED_HIRES])
def test_k4_channels_last_at_a_chunk_of_16(card, idx, dtype):
    """L7, L8 and L10-L13 at the chunk's 16 frames and the channel counts
    the synthesis runs them at (323, 203, 81 and 51 padded to 328, 208, 88
    and 56, the pad planes zero with a zero bias): NHWC bit-equal to NCHW,
    both held to the plain version, the pad channels zero."""
    _, m = LAYERS[idx]
    gen = torch.Generator(device=card).manual_seed(200 + idx)
    conv_hw = m.in_size + m.conv_kernel - 1
    c = m.out_padded
    x = torch.zeros(16, c, conv_hw, conv_hw, device=card, dtype=dtype)
    x[:, :m.out_channels] = (torch.randn(16, m.out_channels, conv_hw, conv_hw, generator=gen,
                                         device=card) * 3).to(dtype)
    b = torch.zeros(c, device=card)
    b[:m.out_channels] = torch.randn(m.out_channels, generator=gen, device=card)
    args = (m.up_taps, m.down_taps, b, m.up, m.down, m.padding, 2 ** 0.5, 0.2, 256.0)
    scales = _distinct_scales(16, c, card)
    want, got = _k4_both_layouts(x, args, scales)
    assert torch.equal(got, want)
    assert not got[:, m.out_channels:].any()
    plain = _plain_by_frames(x, args, scales)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert (want.float() - plain.float()).abs().max().item() <= tol * max(
        1.0, plain.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k4_walk_with_a_ragged_last_block(card, dtype):
    """L11's shape at a frame count whose planes the plan's walk does not
    divide: the last block of each tile walks fewer planes."""
    idx = HIRES[1]
    _, m = LAYERS[idx]
    conv_hw = m.in_size + m.conv_kernel - 1
    itemsize = torch.empty((), dtype=dtype).element_size()
    nq, kd = k4.instantiated_taps(m.up, m.down, len(m.up_taps), len(m.down_taps))
    lay = k4.choose_tile(m.out_size, m.out_size, m.up, m.down, nq, kd, m.padding, itemsize)
    tiles = (-(-m.out_size // lay["th"])) ** 2

    def walk(n):
        return k4.plane_walk(n * m.out_channels, tiles, lay["smem_bytes"])[0]

    n = next(n for n in range(1, 17) if walk(n) > 1 and n * m.out_channels % walk(n))
    gen = torch.Generator(device=card).manual_seed(7)
    x = (torch.randn(n, m.out_channels, conv_hw, conv_hw, generator=gen, device=card) * 3
         ).to(dtype)
    _check_against_plain(m, idx, x, gen, dtype, _distinct_scales(n, m.out_channels, card))


def test_k4_prefetch_counter_after_a_stylegan3_chunk(card, monkeypatch):
    """``filtered_lrelu_cuda.prefetched_planes`` over one StyleGAN3-T chunk
    of 16 frames at the published widths: above zero, and the sum over the
    chunk's 15 launches of their plans' blocks × (planes walked − 1)."""
    from stylegan_directions_face_reenactment_tpu_torch.utils import profiling
    from stylegan_directions_face_reenactment_tpu_torch.weights.stylegan3 import init_stylegan3
    g = init_stylegan3(3, device=card)
    z = torch.randn(16, 512, generator=torch.Generator(device=card).manual_seed(2), device=card)
    plans, plan_for = [], k4.plan_for

    def recorded(*a, **k):
        plans.append(plan_for(*a, **k))
        return plans[-1]

    with torch.no_grad():
        lat = sg3.style_to_wplus(g, [sg3.mapping(g, z)])
        monkeypatch.setattr(k4, "plan_for", recorded)
        before = profiling.counters()
        sg3.synthesis(g, lat)
        torch.cuda.synchronize()
        after = profiling.counters()
    want = 0
    for plan in plans:
        p = plan.params
        # NCHW: runs of planes; NHWC: runs of each sample's channels
        walked = [min(p.pz, p.channels - z % p.runs * p.pz) if p.nhwc else
                  min(p.pz, p.planes - z * p.pz) for z in range(p.gz)]
        assert sum(walked) == p.planes and min(walked) >= 1
        want += p.gx * p.gy * sum(w - 1 for w in walked)
    assert len(plans) == 15 == after["filtered_lrelu_cuda.launches"] - before[
        "filtered_lrelu_cuda.launches"]
    got = after["filtered_lrelu_cuda.prefetched_planes"] - before[
        "filtered_lrelu_cuda.prefetched_planes"]
    assert got == want > 0


def test_k4_synthesis_matches_plain_synthesis(card, monkeypatch):
    from stylegan_directions_face_reenactment_tpu_torch.weights.stylegan3 import init_stylegan3
    g = init_stylegan3(5, device=card, resolution=256, channel_base=8192, channel_max=256)
    z = torch.randn(2, 512, generator=torch.Generator(device=card).manual_seed(1), device=card)
    with torch.no_grad():
        lat = sg3.style_to_wplus(g, [sg3.mapping(g, z)])
        got = sg3.synthesis(g, lat)
        monkeypatch.setattr(sg3, "filtered_lrelu", lambda x, *a, **k: k4.filtered_lrelu_plain(
            x, *a, **k))
        want = sg3.synthesis(g, lat)
    err = (got - want).abs().max().item()
    assert err <= 2e-4 * want.abs().max().item(), err


def test_stylegan3_synthesis_runs_channels_last(card):
    """A StyleGAN3-T synthesis at 1024² (2 frames, TF32 as the cells run it)
    under a profiler: no layout transpose (``nchwToNhwc`` / ``nhwcToNchw``)
    among the kernels of its ``reenact.synthesis`` span, and at most one
    padding copy (ToRGB's 3 output channels, which the synthesis keeps: the
    image stays a contiguous NHWC tensor); all 15 K4 launches on
    channels-last."""
    from torch.profiler import ProfilerActivity, profile
    from stylegan_directions_face_reenactment_tpu_torch.utils import profiling
    from stylegan_directions_face_reenactment_tpu_torch.weights.stylegan3 import init_stylegan3
    g = init_stylegan3(4, device=card)
    z = torch.randn(2, 512, generator=torch.Generator(device=card).manual_seed(3), device=card)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            lat = sg3.style_to_wplus(g, [sg3.mapping(g, z)])
            sg3.synthesis(g, lat)
            torch.cuda.synchronize()
            before = profiling.counters()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with profiling.span("reenact.synthesis"):
                    img = sg3.synthesis(g, lat)
                torch.cuda.synchronize()
            after = profiling.counters()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    kernels = {e.key: e.count for e in prof.key_averages() if e.device_time_total > 0}
    transposes = sorted(k for k in kernels if "nchwToNhwc" in k or "nhwcToNchw" in k)
    assert not transposes, transposes
    pads = {k: n for k, n in kernels.items() if "Padding" in k}
    assert sum(pads.values()) <= 1, pads
    assert any("filtered_lrelu_kernel" in k for k in kernels)
    counted = {k: after[k] - before[k] for k in after}
    assert counted["filtered_lrelu_cuda.nhwc_launches"] == 15 == counted[
        "filtered_lrelu_cuda.launches"]
    assert img.shape == (2, 1024, 1024, 3) and img.is_contiguous()
    assert bool(torch.isfinite(img).all())
