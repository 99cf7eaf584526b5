"""The port's StyleGAN3-T (``models/stylegan3.py``) and K4's plain version
(``ops/filtered_lrelu.py``), on the CPU at small sizes.

The JAX package has no StyleGAN3, so the yardstick here is the benchmark's
plain reference, written from NVlabs' ``networks_stylegan3.py`` and
``_filtered_lrelu_ref`` (``port_bench/reference/model/``), and scipy's
``firwin``. Tolerances, each with its reason:

* the generator against the reference, 2e-5·max|reference|: the port runs
  the modulated conv by the input/output-scaling identity and K4's plain
  version polyphase-free but in another order than NVlabs' per-sample
  grouped convolution and zero-stuffed FIR, through 7 layers of float32;
* K4's plain version against NVlabs' reference, 1e-5·max(1, max|ref|): the
  same taps and the same two 1-D passes, summed in another order by the
  two convolutions;
* the replay of the kernel's tiles against the plain version, 1e-5·max:
  float32 sums of at most 24 taps in another order;
* the filters against scipy, 1e-7: float32 rounding of the same formula;
* the synthesis channels-last against the same synthesis NCHW, 2e-6·max:
  the CPU's convolutions sum in another order in either layout (K4's plain
  version gives the same bits in both).
"""

import os
import sys

import numpy as np
import pytest
import scipy.signal
import torch

from stylegan_directions_face_reenactment_tpu_torch.models import stylegan3 as sg3
from stylegan_directions_face_reenactment_tpu_torch.ops import filtered_lrelu as k4
from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
    generate_image, get_shifted_latent_code, make_fused_reenact_fn, make_reenact_fn)
from stylegan_directions_face_reenactment_tpu_torch.pipeline.synthesis import (
    generator_functions)
from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
from stylegan_directions_face_reenactment_tpu_torch.weights.stylegan3 import init_stylegan3

from torch._subclasses.fake_tensor import FakeTensorMode

from torch_threads import _threads  # noqa: F401

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "port_bench")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from reference.model.models import stylegan3 as ref_sg3  # noqa: E402
from reference.model.ops.filtered_lrelu import filtered_lrelu_ref  # noqa: E402

PUBLISHED = ("L0_36_512 L1_36_512 L2_52_512 L3_52_512 L4_84_512 L5_148_512 L6_148_512 "
             "L7_276_323 L8_276_203 L9_532_128 L10_1044_81 L11_1044_51 L12_1044_32 "
             "L13_1024_32 L14_1024_3").split()
SMALL = dict(resolution=64, channel_base=2048, channel_max=64, num_layers=6)
TINY16 = dict(resolution=32, channel_base=512, channel_max=16, num_layers=14)


@pytest.fixture(scope="module")
def small():
    """A seeded 64² generator (6 layers, 8 W+ rows), the reference holding
    the same state dict, and two W+ codes near the mapped ones."""
    g = init_stylegan3(3, device="cpu", **SMALL)
    r = ref_sg3.Generator(SMALL["resolution"], 512, 2, **{k: v for k, v in SMALL.items()
                                                           if k != "resolution"})
    r.load_state_dict(g.state_dict())
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        w = sg3.mapping(g, torch.randn(2, 512, generator=gen))
        lat = sg3.style_to_wplus(g, [w]) + 0.2 * torch.randn(2, g.n_latent, 512, generator=gen)
    return g, r, lat


def test_published_layer_table():
    """The schedule at the published 1024-T settings, names included."""
    g = sg3.Generator()
    assert g.layer_names == PUBLISHED
    assert g.n_latent == 16
    ups = [(m.up, m.down, len(m.up_taps or (1,)), len(m.down_taps or (1,))) for m in g.layers()]
    assert ups[2] == ups[10] == (4, 2, 24, 12) and ups[1] == ups[13] == (2, 2, 12, 12)
    assert ups[14] == (1, 1, 1, 1)
    assert g.layers()[13].padding == (-11, -12, -11, -12)
    sch = g.schedule
    assert [s["rate"] for s in sch[:8]] == [16, 16, 32, 32, 64, 128, 128, 256]
    assert sum(p.numel() for p in g.synthesis.parameters()) == 21787855


def test_filters_match_scipy_firwin():
    g = sg3.Generator()
    sch = g.schedule
    for i, m in enumerate(g.layers()[:-1]):
        prev = max(i - 1, 0)
        fs = max(sch[prev]["rate"], sch[i]["rate"]) * 2
        up = scipy.signal.firwin(numtaps=len(m.up_taps), cutoff=sch[prev]["cutoff"],
                                 width=sch[prev]["half_width"] * 2, fs=fs)
        down = scipy.signal.firwin(numtaps=len(m.down_taps), cutoff=sch[i]["cutoff"],
                                   width=sch[i]["half_width"] * 2, fs=fs)
        assert np.abs(np.array(m.up_taps) - up).max() < 1e-7
        assert np.abs(np.array(m.down_taps) - down).max() < 1e-7


def test_state_dict_layout_is_nvlabs():
    """NVlabs' G_ema names: the mapping's fc layers and w_avg, the Fourier
    input's buffers, each layer's parameters, magnitude_ema and filters
    (none on ToRGB); the reference has the same keys and shapes."""
    g = sg3.Generator(**SMALL)
    sd = g.state_dict()
    assert {"mapping.fc0.weight", "mapping.fc1.bias", "mapping.w_avg",
            "synthesis.input.weight", "synthesis.input.affine.weight",
            "synthesis.input.transform", "synthesis.input.freqs",
            "synthesis.input.phases"} <= set(sd)
    for name in g.layer_names:
        keys = {k.split(".", 2)[2] for k in sd if k.startswith(f"synthesis.{name}.")}
        want = {"weight", "bias", "magnitude_ema", "affine.weight", "affine.bias"}
        if name != g.layer_names[-1]:
            want |= {"up_filter", "down_filter"}
        assert keys == want, name
    r = ref_sg3.Generator(SMALL["resolution"], 512, 2, **{k: v for k, v in SMALL.items()
                                                           if k != "resolution"})
    assert {k: tuple(v.shape) for k, v in r.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}


def test_generator_matches_reference(small):
    g, r, lat = small
    with torch.no_grad():
        assert torch.equal(sg3.mapping(g, lat[:, 0]), r.mapping(lat[:, 0]))
        got = sg3.synthesis(g, lat)
        want = ref_sg3.synthesis(r, lat)
    assert got.shape == want.shape == (2, 64, 64, 3)
    err = (got - want).abs().max().item()
    assert err <= 2e-5 * want.abs().max().item(), err


ODD = dict(resolution=64, channel_base=1000, channel_max=61, num_layers=6)


def test_padded_channels_match_reference():
    """Channel counts that are no multiple of 8 (61, 31): the port pads its
    activations with zero channels, the reference does not."""
    g = init_stylegan3(5, device="cpu", **ODD)
    assert [(m.in_channels, m.in_padded, m.out_channels, m.out_padded) for m in g.layers()][2:5] \
        == [(61, 64, 61, 64), (61, 64, 31, 32), (31, 32, 16, 16)]
    r = ref_sg3.Generator(ODD["resolution"], 512, 2, **{k: v for k, v in ODD.items()
                                                         if k != "resolution"})
    r.load_state_dict(g.state_dict())
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        lat = sg3.style_to_wplus(g, [sg3.mapping(g, torch.randn(2, 512, generator=gen))])
        got = sg3.synthesis(g, lat)
        want = ref_sg3.synthesis(r, lat)
    err = (got - want).abs().max().item()
    assert err <= 2e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("kw", [SMALL, ODD], ids=["small", "padded"])
def test_synthesis_gives_the_same_image_in_either_layout(kw, monkeypatch):
    """The synthesis channels-last (its layout) and NCHW: the same image, and
    the channels-last one a contiguous NHWC tensor."""
    g = init_stylegan3(3, device="cpu", **kw)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        lat = sg3.style_to_wplus(g, [sg3.mapping(g, torch.randn(2, 512, generator=gen))])
        nhwc = sg3.synthesis(g, lat)
        monkeypatch.setattr(sg3, "MEMORY_FORMAT", torch.contiguous_format)
        nchw = sg3.synthesis(g, lat)
    assert nhwc.is_contiguous() and not nchw.is_contiguous()
    err = (nhwc - nchw).abs().max().item()
    assert err <= 2e-6 * nchw.abs().max().item(), err


def test_bf16_synthesis_stays_near_float32(small):
    """The control's precision runs: bf16 convolutions and K4 planes."""
    g, _, lat = small
    with torch.no_grad():
        f32 = sg3.synthesis(g, lat)
        bf16 = sg3.synthesis(g, lat, compute_dtype=torch.bfloat16)
    assert bf16.dtype == torch.float32
    err = (bf16 - f32).abs().max().item()
    assert 0 < err < 0.1 * f32.abs().max().item(), err


@pytest.mark.parametrize("clamp", [None, 0.5], ids=["no_clamp", "clamp"])
@pytest.mark.parametrize("up,down", [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2)])
def test_k4_plain_matches_nvlabs_reference(up, down, clamp):
    gen = torch.Generator().manual_seed(10 * up + down)
    ku, kd = 6 * up if up > 1 else 1, 6 * down if down > 1 else 1
    fu = sg3.design_lowpass_filter(ku, 3.0, 2.0, 8.0 * up)
    fd = sg3.design_lowpass_filter(kd, 3.0, 2.0, 8.0 * up)
    x = torch.randn(2, 3, 19, 23, generator=gen)
    b = torch.randn(3, generator=gen)
    pad = (3, -2, 5, 1)
    got = k4.filtered_lrelu_plain(x, fu, fd, b, up, down, pad, 1.5, 0.2, clamp)
    want = filtered_lrelu_ref(x, None if fu is None else torch.tensor(fu),
                              None if fd is None else torch.tensor(fd), b, up, down, pad, 1.5,
                              0.2, clamp)
    assert got.shape == want.shape
    assert got.shape[2:] == k4.output_shape(19, 23, ku, kd, up, down, pad)
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())
    if clamp is not None:
        assert want.abs().max().item() <= clamp * 1.0001 or down > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k4_takes_channels_last(dtype):
    """The plain version and ``sdfr::filtered_lrelu`` on an NHWC batch: the
    same bits as on the NCHW batch, in the NHWC layout; the fake operator
    gives the same strides; ``opcheck`` holds both layouts."""
    gen = torch.Generator().manual_seed(13)
    m = sg3.Generator(**SMALL).layers()[2]
    x = torch.randn(2, 5, 21, 17, generator=gen).to(dtype)
    xc = x.contiguous(memory_format=torch.channels_last)
    assert k4.is_nhwc(xc) and not k4.is_nhwc(x)
    b, s_in, s_out = (torch.randn(5, generator=gen), torch.rand(2, 5, generator=gen) + 0.5,
                      torch.rand(2, 5, generator=gen) + 0.5)
    args = (m.up_taps, m.down_taps, b, m.up, m.down, m.padding, 2 ** 0.5, 0.2, 1.0)
    for fn in (k4.filtered_lrelu_plain, k4.filtered_lrelu):
        want = fn(x, *args, in_scale=s_in, out_scale=s_out)
        got = fn(xc, *args, in_scale=s_in, out_scale=s_out)
        assert want.is_contiguous() and k4.is_nhwc(got) and got.dtype == dtype
        assert torch.equal(got, want)
    op_args = (xc, b, list(k4._taps(m.up_taps)), list(k4._taps(m.down_taps)), m.up, m.down,
               list(m.padding), 2 ** 0.5, 0.2, 1.0, s_in, s_out)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = k4.filtered_lrelu_op(*op_args)
    assert fake.shape == got.shape and fake.stride() == got.stride()
    torch.library.opcheck(k4.filtered_lrelu_op, op_args)
    torch.library.opcheck(k4.filtered_lrelu_op, (x.contiguous(),) + op_args[1:])


def test_k4_plain_scales_each_plane_on_the_way_in_and_out():
    gen = torch.Generator().manual_seed(12)
    m = sg3.Generator(**SMALL).layers()[1]
    x = torch.randn(2, 3, 30, 30, generator=gen)
    b, s_in, s_out = (torch.randn(3, generator=gen), torch.rand(2, 3, generator=gen) + 0.5,
                      torch.rand(2, 3, generator=gen) + 0.5)
    args = (m.up_taps, m.down_taps, b, m.up, m.down, m.padding, 2 ** 0.5, 0.2, 4.0)
    got = k4.filtered_lrelu(x, *args, in_scale=s_in, out_scale=s_out)
    want = k4.filtered_lrelu_plain(x * s_in[:, :, None, None], *args) * s_out[:, :, None, None]
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def _replay(x, b, fu, fd, up, down, pad, gain, slope, clamp, in_scale=None, out_scale=None,
            itemsize=4, e0=0, pz=None, group=0):
    """K4's schedule (``csrc/filtered_lrelu.cu``) replayed in numpy, as the
    launch plan lays it out: a block a tile walks ``pz`` planes (the plan's
    walk unless given); every region in one shared memory of the plan's
    size, a word a row of ``mem`` holding ``4 / itemsize`` elements (a float
    of regions B and C and of the staging tiles in its first column), so
    that a region that overlapped a live one would spoil the answer. The
    input starts ``e0`` elements past a 4-byte boundary; what a fetched word
    holds outside the plane is NaN.

    ``group`` 0, an NCHW batch: the next plane's input lands in the other
    slot before the current one is filtered. ``group`` g ≥ 1, ``x`` held
    NHWC (channels-last): a block walks one sample's channels, ``pz`` of
    them (the plan's :func:`channel_walk` unless given), in groups of g
    whose tiles are copied together, a word an element into its plane's
    slot; each plane's output goes to its staging tile (in its own slot once
    the plane is upsampled along x, where it fits, else after region C), and
    the group's tiles are stored a pixel at a time, their channels side by
    side; the next group's inputs go in flight once the group's last plane
    has been upsampled along x (staging of its own) or once the group is
    stored (staging in the slots).
    Returns the output (N, C, H, W) and how often each (tile, plane) was
    made."""
    n, c, h, w = x.shape
    planes = n * c
    fu, fd = k4._taps(fu), k4._taps(fd)
    nq, kd = k4.instantiated_taps(up, down, len(fu), len(fd))
    px0, _, py0, _ = pad
    oh, ow = k4.output_shape(h, w, len(fu), len(fd), up, down, pad)
    lay = k4.choose_tile(oh, ow, up, down, nq, kd, pad, itemsize, group)
    group = lay["group"]      # a group of which no tile fits is halved
    th, tw, run, drun, per = lay["th"], lay["tw"], k4.RUN, k4.DOWN_RUN, 4 // itemsize
    ih, iw, mh, mw, mh_used = lay["ih"], lay["iw"], lay["mh"], lay["mw"], lay["mh_used"]
    p_in, p_hu, p_mid, p_hd = lay["p_in"], lay["p_hu"], lay["p_mid"], lay["p_hd"]
    gx, gy = -(-ow // tw), -(-oh // th)
    words = lay["smem_bytes"] // 4
    if group:
        if pz is None:
            pz, runs, gz = k4.channel_walk(n, c, gx * gy, lay["smem_bytes"], group)
        else:
            runs = -(-c // pz)
            gz = n * runs
        assert pz * (runs - 1) < c <= pz * runs
        # NHWC in device memory: a pixel's channels side by side
        data = x.permute(0, 2, 3, 1).numpy().ravel()
        s_out, off_out = lay["s_out"], lay["off_out"]
        assert lay["slot"] >= ih * p_in and p_in >= iw and lay["slot"] % 32 == 32 // group % 32
        assert s_out >= th * tw and s_out % 32 == 32 // group % 32
        assert lay["off_hu"] == group * lay["slot"]
        if off_out:
            assert off_out == lay["off_mid"] + mh * p_mid and th * tw > ih * p_in
            assert words == off_out + (group - 1) * s_out + th * tw
        else:
            assert s_out == lay["slot"] and th * tw <= ih * p_in
            assert words == lay["off_mid"] + mh * p_mid
        out = np.full((n, oh, ow, c), np.nan, np.float32)
    else:
        if pz is None:
            pz, gz = k4.plane_walk(planes, gx * gy, lay["smem_bytes"])
        else:
            gz = -(-planes // pz)
        assert pz * (gz - 1) < planes <= pz * gz
        data = x.numpy().ravel()
        assert words == lay["off_mid"] + mh * p_mid and lay["off_hu"] == 2 * lay["slot"]
        assert lay["slot"] == ih * p_in and p_in >= k4.slot_words(iw, itemsize)
        out = np.full((planes, oh, ow), np.nan, np.float32)
    stride = k4.MAX_TAPS // up
    fph = k4.phase_taps(fu, up).ravel()
    fdf = np.zeros(k4.MAX_TAPS, np.float32)
    fdf[:len(fd)] = np.asarray(fd, np.float32)[::-1]
    wu, wd = (run - 1 + up - 1) // up + nq, (drun - 1) * down + kd
    phases = [((up - u % up) % up, (u + up - 1) // up) for u in range(run)]
    # the input as the card holds it, behind e0 elements and before a spare
    flat = np.concatenate([np.full(e0, np.nan, np.float32), data,
                           np.full(per, np.nan, np.float32)])
    a_in = np.ones(planes, np.float32) if in_scale is None else in_scale.numpy().ravel()
    a_out = np.ones(planes, np.float32) if out_scale is None else out_scale.numpy().ravel()
    made = np.zeros((gy, gx, planes), np.int64)

    def region(off, rows, pitch, cols):
        """Word indices of a region's rows × cols, inside the shared memory."""
        idx = off + np.arange(rows)[:, None] * pitch + np.arange(cols)[None]
        assert idx.min() >= 0 and idx.max() < words
        return idx

    def up_run(win):
        return np.stack([sum(fph[ph * stride + q] * win[st + q] for q in range(nq))
                         for ph, st in phases])

    def down_run(win):
        return np.stack([sum(fdf[k] * win[u * down + k] for k in range(kd))
                         for u in range(drun)])

    for ty in range(gy):
        for tx in range(gx):
            oy0, ox0 = ty * th, tx * tw
            assert (oy0 * down - lay["dy"] - py0) % up == 0
            iy0 = (oy0 * down - lay["dy"] - py0) // up
            ix0 = (ox0 * down - lay["dx"] - px0) // up
            lo, hi = max(0, -ix0), min(iw, w - ix0)
            edge = iy0 < 0 or iy0 + ih > h or ix0 < 0 or ix0 + iw > w
            rows_in = (np.arange(ih) + iy0 >= 0) & (np.arange(ih) + iy0 < h)
            cols_in = (np.arange(iw) >= lo) & (np.arange(iw) < hi)
            vh, vw = min(th, oh - oy0), min(tw, ow - ox0)    # the tile's outputs inside
            for z in range(gz):
                mem = np.full((words, per), np.nan, np.float64)

                def x_up(raw, plane):
                    """2. x-up from a landed raw tile: scale, bias, zeros outside."""
                    v = raw * a_in[plane] + np.float32(b[plane % c].item())
                    if edge:
                        v = np.where(rows_in[:, None] & cols_in[None], v, np.float32(0))
                    assert not np.isnan(v).any()
                    hu = region(lay["off_hu"], ih, p_hu, mw)
                    for c0 in range(0, mw, run):
                        win = v[:, c0 // up: c0 // up + wu].T
                        assert win.shape[0] == wu
                        mem[hu[:, c0:c0 + run], 0] = up_run(win).T
                    return hu

                def rest(hu, plane):
                    """3.-5.: y-up and the activation, x-down into region B, y-down
                    and the output scale; the tile's outputs inside the plane."""
                    mid = region(lay["off_mid"], mh, p_mid, mw)
                    s_hu = mem[hu, 0].astype(np.float32)
                    for r0 in range(0, mh, run):
                        win = s_hu[r0 // up: r0 // up + wu]
                        assert win.shape[0] == wu
                        u = up_run(win)
                        u = np.where(u < 0, u * slope, u) * gain
                        mem[mid[r0:r0 + run], 0] = u if clamp is None else np.clip(u, -clamp,
                                                                                    clamp)
                    s_mid = mem[mid, 0].astype(np.float32)
                    hd = region(lay["off_hu"], mh_used, p_hd, tw)
                    for t0 in range(0, tw, drun):
                        s0 = lay["dx"] + t0 * down
                        win = s_mid[:mh_used, s0:s0 + wd].T
                        assert win.shape[0] == wd
                        mem[hd[:, t0:t0 + drun], 0] = down_run(win).T
                    s_hd = mem[hd, 0].astype(np.float32)
                    o = np.concatenate([down_run(s_hd[lay["dy"] + t0 * down:][:wd])
                                        for t0 in range(0, th, drun)])
                    return (o * a_out[plane])[:vh, :vw]

                if group:
                    ns, c0 = divmod(z, runs)
                    c0 *= pz
                    walked = min(pz, c - c0)
                    # element index of the walk's first channel at (input row 0,
                    # tile column 0) of its sample
                    e_in = e0 + ns * h * w * c + c0 + ix0 * c
                    pix = ((iy0 + np.arange(ih))[:, None] * w + np.arange(iw)[None]) * c

                    def issue(k0, gr):
                        """A group's tiles, an element a word, into slots 0 .. g - 1
                        (zero-filled past the group's gr channels and outside)."""
                        for g in range(group):
                            e = e_in + k0 + g + pix
                            fetch = (g < gr) & rows_in[:, None] & cols_in[None]
                            first = np.where(fetch, e - e % per, 0)
                            got = flat[first[..., None] + np.arange(per)]
                            idx = region(g * lay["slot"], ih, p_in, iw)
                            mem[idx] = np.where(fetch[..., None], got, 0.0)

                    gr = min(group, walked)
                    issue(0, gr)
                    for k in range(walked):
                        plane, gi = ns * c + c0 + k, k % group
                        e = e_in + k + pix
                        raw = mem[region(gi * lay["slot"], ih, p_in, iw), e % per]
                        hu = x_up(raw.astype(np.float32), plane)
                        gr_next = min(group, walked - k - 1)
                        if gi == gr - 1 and gr_next and off_out:
                            issue(k + 1, gr_next)
                        mem[region(off_out + gi * s_out, vh, tw, vw), 0] = rest(hu, plane)
                        made[ty, tx, plane] += 1
                        if gi == gr - 1:
                            base = c0 + k - gi
                            for g in range(gr):
                                tile = mem[region(off_out + g * s_out, vh, tw, vw), 0]
                                dst = out[ns, oy0:oy0 + vh, ox0:ox0 + vw, base + g]
                                assert np.isnan(dst).all()
                                dst[...] = tile
                            if gr_next and not off_out:
                                issue(k + 1, gr_next)
                            gr = gr_next
                    continue

                plane0 = z * pz
                walked = min(pz, planes - plane0)

                def issue(plane, slot):
                    """A plane's input tile into a slot, word by word."""
                    base = e0 + plane * h * w + iy0 * w + ix0
                    nw = k4.slot_words(iw, itemsize)
                    idx = region(slot * lay["slot"], ih, p_in, nw)
                    for r in range(ih):
                        e = base + r * w
                        s = e % per
                        for j in range(nw):
                            col = j * per - s
                            fetch = 0 <= iy0 + r < h and col < hi and col + per > lo
                            first = e - s + j * per
                            mem[idx[r, j]] = flat[first:first + per] if fetch else 0.0

                issue(plane0, 0)
                for k in range(walked):
                    plane = plane0 + k
                    if k + 1 < walked:
                        issue(plane + 1, (k + 1) % 2)
                    slot = mem[k % 2 * lay["slot"]:(k % 2 + 1) * lay["slot"]].ravel()
                    e_row = e0 + plane * h * w + iy0 * w + ix0 + np.arange(ih) * w
                    halves = (np.arange(ih) * p_in * per + e_row % per)[:, None] + np.arange(iw)
                    hu = x_up(slot[halves].astype(np.float32), plane)
                    out[plane, oy0:oy0 + vh, ox0:ox0 + vw] = rest(hu, plane)
                    made[ty, tx, plane] += 1
    if group:
        return torch.from_numpy(out).permute(0, 3, 1, 2), made
    return torch.from_numpy(out.reshape(n, c, oh, ow)), made


REPLAYED = [
    (2, 2, 12, 12, (9, 8, 9, 8), 46),            # L1, L3, ... : two tiles a side
    (4, 2, 24, 12, (-6, -9, -6, -9), 18),         # L2, L4, ... L10
    (2, 2, 12, 12, (-11, -12, -11, -12), 40),     # L13, the crop to 1024
    (1, 1, 1, 1, (0, 0, 0, 0), 9),                # L14, ToRGB
    (2, 1, 5, 3, (1, 2, 3, 0), 7),                # any other count: zero-padded to 24
    (1, 2, 4, 7, (2, 2, 1, 3), 40),
    (1, 1, 5, 7, (3, 2, 3, 2), 17),
    (2, 2, 8, 24, (12, 11, 12, 11), 21),
    (4, 1, 24, 3, (13, 12, 13, 12), 11),
    (4, 2, 16, 10, (14, 11, -3, 9), 17),
]
REPLAYED_IDS = ["up2", "up4", "crop", "torgb", "generic_up", "generic_down", "generic_11",
                "generic_22", "generic_41", "generic_42"]


def _replay_case(up, down, ku, kd, pad, size, planes=(1, 7), scales=True, dtype=torch.float32):
    """Inputs of a replay case (``planes`` as (N, C)), its plain version and
    its arguments; per-plane scales that differ plane by plane."""
    gen = torch.Generator().manual_seed(size)
    fu = sg3.design_lowpass_filter(ku, 3.0, 2.0, 8.0 * up)
    fd = sg3.design_lowpass_filter(kd, 3.0, 2.0, 8.0 * up)
    x = torch.randn(*planes, size, size + 3, generator=gen).to(dtype).float()
    b = torch.randn(planes[1], generator=gen)
    s = {}
    if scales:
        s = dict(in_scale=0.5 + torch.arange(planes[0] * planes[1]).float().view(*planes) / 4,
                 out_scale=2.0 - torch.arange(planes[0] * planes[1]).float().view(*planes) / 5)
    args = (fu, fd, b, up, down, pad, 1.41, 0.2, 1.0)
    want = k4.filtered_lrelu_plain(x, *args, **s)
    return x, args, s, want


@pytest.mark.parametrize("up,down,ku,kd,pad,size", REPLAYED, ids=REPLAYED_IDS)
def test_kernel_tiles_replay_the_plain_version(up, down, ku, kd, pad, size):
    """7 planes walked 4 at a time (a block of 4, a block of 3), each with
    its own input and output scale."""
    x, (fu, fd, b, *rest), s, want = _replay_case(up, down, ku, kd, pad, size)
    got, made = _replay(x, b, fu, fd, *rest, **s, pz=4)
    assert (made == 1).all()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("up,down,ku,kd,pad,size", REPLAYED, ids=REPLAYED_IDS)
def test_kernel_nhwc_tiles_replay_the_plain_version(up, down, ku, kd, pad, size):
    """An NHWC batch of 2 samples of 11 channels, each sample's channels
    walked 10 at a time in groups of k4.GROUP (a group of 8 and a ragged one
    of 2, then a ragged walk of 1): the group copy into the planes' slots,
    the staging tiles and the store a pixel at a time."""
    x, (fu, fd, b, *rest), s, want = _replay_case(up, down, ku, kd, pad, size, (2, 11))
    xc = x.contiguous(memory_format=torch.channels_last)
    got, made = _replay(xc, b, fu, fd, *rest, **s, pz=10, group=k4.GROUP)
    assert (made == 1).all()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("up,down,ku,kd,pad,size", REPLAYED, ids=REPLAYED_IDS)
def test_kernel_nhwc_filters_the_zero_planes_to_zeros(up, down, ku, kd, pad, size):
    """16 channels of which the last 5 are zero planes with a zero bias (as
    the synthesis pads its channel counts), walked 8 at a time: every plane
    is filtered like any other, and the zero planes come out exactly zero."""
    x, (fu, fd, b, *rest), s, _ = _replay_case(up, down, ku, kd, pad, size, (2, 16))
    x[:, 11:], b[11:] = 0, 0
    want = k4.filtered_lrelu_plain(x, fu, fd, b, *rest, **s)
    assert not want[:, 11:].any()
    got, made = _replay(x.contiguous(memory_format=torch.channels_last), b, fu, fd, *rest, **s,
                        pz=8, group=k4.GROUP)
    assert (made == 1).all()
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())
    assert not got[:, 11:].any()


@pytest.mark.parametrize("up,down,ku,kd,pad,size", REPLAYED, ids=REPLAYED_IDS)
def test_kernel_nhwc_bf16_replay_the_plain_version(up, down, ku, kd, pad, size):
    """bf16 NHWC: an odd channel count (a pixel's channels start on either
    half of a word), the tensor itself on a word's second half, each
    sample's channels walked at once in groups of 4 (two groups of 4, a
    ragged one of 3)."""
    x, (fu, fd, b, *rest), s, want = _replay_case(up, down, ku, kd, pad, size, (2, 11),
                                                  dtype=torch.bfloat16)
    got, made = _replay(x, b, fu, fd, *rest, **s, itemsize=2, e0=1, pz=11, group=4)
    assert (made == 1).all()
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("up,down,ku,kd,pad,size", REPLAYED, ids=REPLAYED_IDS)
def test_kernel_bf16_slots_replay_the_plain_version(up, down, ku, kd, pad, size):
    """bf16 input: two elements a word, rows of odd width starting on either
    half, the tensor itself on a word's second half; 5 planes walked 2 at a
    time."""
    x, (fu, fd, b, *rest), s, want = _replay_case(up, down, ku, kd, pad, size, (1, 5),
                                                  dtype=torch.bfloat16)
    got, made = _replay(x, b, fu, fd, *rest, **s, itemsize=2, e0=1, pz=2)
    assert (made == 1).all()
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


def test_replay_fails_a_plane_off_by_one():
    """The replay's yardstick catches a plane read with its neighbour's
    scales: planes that differ plane by plane."""
    x, (fu, fd, b, *rest), s, want = _replay_case(*REPLAYED[1])
    shifted = dict(in_scale=s["in_scale"].roll(1, dims=1), out_scale=s["out_scale"])
    got, _ = _replay(x, b, fu, fd, *rest, **shifted, pz=4)
    assert (got - want).abs().max().item() > 1e-2 * want.abs().max().item()


def test_launch_plans_fit_the_card():
    """Every published layer's plan, f32 and bf16: a specialised
    instantiation, tiles with both input slots within the shared memory the
    kernel asks for, whole runs; at a chunk of 16 frames a walk of at least
    one plane, every plane in exactly one block, a grid the card takes."""
    g = sg3.Generator()
    for m in g.layers():
        ku, kd = len(m.up_taps or (1.0,)), len(m.down_taps or (1.0,))
        nq, kd_t = k4.instantiated_taps(m.up, m.down, ku, kd)
        assert (m.up, m.down, nq, kd_t) in k4.SPECIALIZED
        for itemsize in (4, 2):
            lay = k4.choose_tile(m.out_size, m.out_size, m.up, m.down, nq, kd_t, m.padding,
                                 itemsize)
            assert lay["smem_bytes"] <= k4.MAX_SMEM
            assert lay["mh"] % k4.RUN == 0 and lay["th"] % k4.DOWN_RUN == 0
            assert lay["slot"] >= lay["ih"] * k4.slot_words(lay["iw"], itemsize)
            assert lay["off_hu"] >= 2 * lay["slot"]
            assert lay["smem_bytes"] >= 4 * (lay["off_hu"] + lay["mh_used"] * lay["p_hd"])
            planes, tiles = 16 * m.out_channels, (-(-m.out_size // lay["th"])) ** 2
            pz, gz = k4.plane_walk(planes, tiles, lay["smem_bytes"])
            assert pz >= 1 and pz * (gz - 1) < planes <= pz * gz and gz <= k4.MAX_GRID_Z
    with pytest.raises(ValueError, match="CUDA"):
        k4.make_plan((1, 1, 8, 8), torch.float32, torch.device("cpu"), None, None, 1, 1,
                     (0, 0, 0, 0), 1.0, 1.0, None)


def test_nhwc_launch_plans_fit_the_card():
    """Every published layer's NHWC plan at a chunk of 16 frames and the
    padded channel counts the synthesis runs, f32 and bf16: groups of
    k4.GROUP channels, slots and staging tiles within the shared memory and
    apart by a word count that spreads a warp's channels over the banks,
    each sample's channels in runs of whole groups, a grid the
    card takes. Plans are made for a CUDA device without a card."""
    g = sg3.Generator()
    dev = torch.device("cuda", 0)
    for m in g.layers():
        conv_hw = m.in_size + m.conv_kernel - 1
        for dtype in (torch.float32, torch.bfloat16):
            plan = k4.make_plan((16, m.out_padded, conv_hw, conv_hw), dtype, dev, m.up_taps,
                                m.down_taps, m.up, m.down, m.padding, 2 ** 0.5, 0.2, 256.0,
                                nhwc=True)
            p = plan.params
            assert p.nhwc == 1 and p.cg == k4.GROUP == 1 << p.lg
            assert k4.resident_blocks(p.smem_bytes) >= 2 and p.smem_bytes <= k4.MAX_SMEM_NHWC
            assert p.slot % 32 == p.s_out % 32 == 32 // p.cg and p.slot >= p.ih * p.p_in
            assert p.off_hu == p.cg * p.slot
            # the output staged in the input slots where a tile fits (up 1 and 2)
            assert (p.off_out == 0) == (m.up < 4)
            assert p.smem_bytes == 4 * max(p.off_mid + p.mh * p.p_mid,
                                           p.off_out + (p.cg - 1) * p.s_out + p.th * p.tw)
            # the walks cover every channel, the zero ones too, in whole groups
            assert p.channels == m.out_padded
            assert p.pz % p.cg == 0 or p.runs == 1
            assert p.pz * (p.runs - 1) < p.channels <= p.pz * p.runs
            assert p.gz == 16 * p.runs <= k4.MAX_GRID_Z
            assert plan.out_shape == (16, m.out_padded, m.out_size, m.out_size)
            assert plan.prefetched == p.gx * p.gy * (16 * m.out_padded - p.gz)


def test_generate_image_shifts_8_of_16_rows():
    """16 W+ rows, a shift on the first 8 (the input and L0-L6): the shifted
    code, and the image of it through the generator's own functions."""
    g = init_stylegan3(6, device="cpu", **TINY16)
    assert g.n_latent == 16 and generator_functions(g) is sg3
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        code = sg3.style_to_wplus(g, [sg3.mapping(g, torch.randn(2, 512, generator=gen))])
        shift = torch.randn(2, 8, 512, generator=gen)
        shifted = get_shifted_latent_code(g, code, shift, input_is_latent=True)
        assert torch.equal(shifted[:, :8], code[:, :8] + shift)
        assert torch.equal(shifted[:, 8:], code[:, 8:])
        img, lat = generate_image(g, code, shift_code=shift, input_is_latent=True,
                                  return_latents=True)
        assert torch.equal(lat, shifted)
        assert torch.equal(img, sg3.synthesis(g, shifted))


@pytest.fixture(scope="module")
def reenact_world():
    from torch_reenact_world import build_world
    world = build_world()
    _, a, deca, pf, ps = world["port"]
    g = init_stylegan3(8, device="cpu", resolution=64, channel_base=1024, channel_max=32,
                       num_layers=14)
    with torch.no_grad():
        z = torch.randn(64, 512, generator=torch.Generator().manual_seed(9))
        trunc = sg3.mapping(g, z).mean(dim=0, keepdim=True)
        code = sg3.style_to_wplus(g, [sg3.mapping(g, z[:1])])
    spec = initialize_directions("ffhq", 15, 6.0)
    return dict(g=g, a=a, deca=deca, pf=pf, ps=ps, trunc=trunc, code=code, spec=spec,
                src=(code, world["ps"], world["ang"]), frames=world["frames"])


def _check_latents_and_images(w, reenacted, latents):
    """The latents: the truncated code with the shift on the first 8 rows;
    the images: the generator's synthesis of those latents."""
    trunc, code = w["trunc"], w["code"]
    want_rest = (trunc + 0.7 * (code - trunc))[:, 8:].expand(latents.shape[0], -1, -1)
    assert latents.shape == (reenacted.shape[0], 16, 512)
    torch.testing.assert_close(latents[:, 8:], want_rest, rtol=0, atol=1e-6)
    assert (latents[:, :8] - (trunc + 0.7 * (code - trunc))[:, :8]).abs().max() > 1e-4
    with torch.no_grad():
        torch.testing.assert_close(reenacted, sg3.synthesis(w["g"], latents), rtol=0,
                                   atol=1e-6)


def test_make_reenact_fn_runs_stylegan3(reenact_world):
    w = reenact_world
    fn = make_reenact_fn(w["g"], w["a"], w["deca"], w["spec"], truncation_latent=w["trunc"],
                         fan_params=w["pf"], s3fd_params=w["ps"], device="cpu")
    crops = torch.from_numpy(w["frames"]).float() / 127.5 - 1.0
    reenacted, latents = fn(*w["src"], crops)
    assert reenacted.shape == (2, 64, 64, 3)
    _check_latents_and_images(w, reenacted, latents)


def test_make_fused_reenact_fn_runs_stylegan3(reenact_world):
    w = reenact_world
    fn = make_fused_reenact_fn(w["g"], w["a"], w["deca"], w["spec"], w["ps"], w["pf"],
                               truncation_latent=w["trunc"], fan_params=w["pf"],
                               s3fd_params=w["ps"], device="cpu")
    reenacted, latents, crops, ok, _, _ = fn(*w["src"], w["frames"])
    assert reenacted.shape == (2, 64, 64, 3) and bool(ok.all())
    _check_latents_and_images(w, reenacted, latents)
    # the same crops through the unfused entry give the same answers
    unfused = make_reenact_fn(w["g"], w["a"], w["deca"], w["spec"],
                              truncation_latent=w["trunc"], fan_params=w["pf"],
                              s3fd_params=w["ps"], device="cpu")
    r2, l2 = unfused(*w["src"], crops.float() / 127.5 - 1.0)
    torch.testing.assert_close(l2, latents, rtol=0, atol=1e-5)


def test_cli_stops_plainly_on_stylegan3(tmp_path):
    from stylegan_directions_face_reenactment_tpu_torch.cli import run_inference
    from stylegan_directions_face_reenactment_tpu_torch.configs.models_config import MODELS
    row = MODELS["ffhq_sg3t"]
    assert row["arch"] == "stylegan3-t" and row["resolution"] == 1024
    with pytest.raises(SystemExit, match="e4e inversion and PTI for StyleGAN3"):
        run_inference.main(["--dataset_type", "ffhq_sg3t", "--device", "cpu",
                            "--source_path", str(tmp_path / "source.png"),
                            "--target_path", str(tmp_path / "target.png"),
                            "--output_path", str(tmp_path / "out"), "--random_init"])
    assert not (tmp_path / "out").exists()
