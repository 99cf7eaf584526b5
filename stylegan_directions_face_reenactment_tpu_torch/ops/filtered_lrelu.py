"""K4: the fused filtered leaky ReLU of StyleGAN3's synthesis layers, a
hand-written CUDA kernel (``csrc/filtered_lrelu.cu``) and its plain version.

The JAX package has no StyleGAN3 and so no TPU kernel for this: K4 was
added with the port's StyleGAN3-T generator (``models/stylegan3.py``), whose
every layer runs modulated conv → filtered leaky ReLU. What it computes
(NVlabs' ``_filtered_lrelu_ref``), per plane of a batch (N, C, H, W):

  1. scale each plane by ``in_scale`` (one value a plane, or none), add the
     bias;
  2. upsample by ``up`` through the separable FIR ``fu`` (zero-stuff, pad by
     (px0, px1, py0, py1), convolve with ``fu`` times ``up`` along each
     axis, so the 2-D gain is ``up**2``);
  3. leaky ReLU of slope ``slope``, times ``gain``, clamped to
     [-clamp, clamp] (no clamp when ``clamp`` is None);
  4. downsample by ``down`` through the separable FIR ``fd`` (no padding:
     convolve, keep every ``down``-th sample), and scale each plane by
     ``out_scale`` (or none).

The two scales let a StyleGAN3 layer hand K4 its modulated conv's
demodulation and the next layer's styles, so that neither is a pass of its
own over the planes in device memory (``models/stylegan3.py``).

The batch may be NCHW (contiguous) or NHWC (``torch.channels_last``): the
output takes the input's layout, every version reads the layout from the
strides, and both give the same values. StyleGAN3's activations are
channels-last, the layout cuDNN's convolutions run in, so that no layout
transpose stands between a convolution and K4. StyleGAN3 pads its channel
counts with zero planes of a zero bias, which filter to zero planes like
any others.

Output size per axis: ``(in·up + p0 + p1 − (ku − 1) − (kd − 1) + down − 1)
// down``. Taken: up in {1, 2, 4}, down in {1, 2}, at most 24 taps in each
filter (``None`` is the 1-tap identity), float32 and bf16 planes, sums in
float32.

Bound on an H100: the FIR FMAs on the CUDA cores and the bytes, about
equally at the published 1024² layers (one read of the input, one write of
the output; the upsampled plane is four times the output and never leaves
shared memory). The source says what its design does about that: a block
owns one output tile and walks a run of planes of it, the next plane's
input in flight while the current one is filtered (on an NHWC batch, a
group of channels' inputs at once, so that copies and stores are runs of
channels); the plan chooses the tile and the run from the shape and layout
(:func:`choose_tile`, :func:`plane_walk`).

* :func:`filtered_lrelu_plain` is the plain version: upfirdn2d → bias, act,
  clamp → upfirdn2d, each filter applied as two 1-D passes.
* ``sdfr::filtered_lrelu`` (``filtered_lrelu_op``) is the registered
  operator: its plain version on a CPU tensor, the kernel on a CUDA tensor,
  shapes alone under fake tensors. It has no autograd formula: nothing
  differentiates through StyleGAN3 in the port yet.
* :func:`filtered_lrelu_cuda` launches K4 from a launch plan made once per
  shape (:func:`plan_for`), counting ``filtered_lrelu_cuda.launches``,
  ``filtered_lrelu_cuda.nhwc_launches`` (the launches on an NHWC batch),
  ``filtered_lrelu_cuda.plan_misses`` (a plan made anew) and
  ``filtered_lrelu_cuda.prefetched_planes`` (planes whose input a block had
  in flight before it needed them: blocks × (planes walked − 1)).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .kernel_build import check, load_library, on_card_of, register_op
from .upfirdn2d import normalize_pad, upfirdn2d

MAX_TAPS = 24
_UPS, _DOWNS = (1, 2, 4), (1, 2)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
RUN = 8            # rows (columns) of the upsampled tile one thread makes in a pass
DOWN_RUN = 4       # outputs one thread makes in a downsampling pass
TILES = tuple(range(16, 41, 4))   # the output tile's sides the plan chooses from
MAX_SMEM = 96 * 1024               # at least two blocks an SM
MAX_SMEM_NHWC = 112 * 1024         # two blocks an SM
# the H100 a plan is made for: SMs, shared memory an SM, shared memory the
# card keeps back a block, resident blocks an SM at 256 threads a block
SMS, SM_SMEM, BLOCK_SMEM_RESERVED, MAX_BLOCKS_SM = 132, 228 * 1024, 1024, 8
WAVES = 8          # waves of blocks a layer keeps at the least (plane_walk)
MAX_WALK = 32      # planes a block walks at the most (plane_walk)
MAX_GRID_Z = 65535
GROUP = 8          # channels of an NHWC batch a block copies and stores together


def output_shape(in_h: int, in_w: int, ku: int, kd: int, up: int, down: int,
                 pad) -> Tuple[int, int]:
    px0, px1, py0, py1 = normalize_pad(pad)
    out_h = (in_h * up + py0 + py1 - (ku - 1) - (kd - 1) + down - 1) // down
    out_w = (in_w * up + px0 + px1 - (ku - 1) - (kd - 1) + down - 1) // down
    return out_h, out_w


def _taps(f) -> Tuple[float, ...]:
    """A 1-D filter as a tuple of floats; ``None`` is the identity."""
    if f is None:
        return (1.0,)
    if isinstance(f, tuple) and all(type(v) is float for v in f) and 1 <= len(f) <= MAX_TAPS:
        return f
    if isinstance(f, torch.Tensor):
        f = f.detach().cpu().numpy()
    t = tuple(float(v) for v in np.asarray(f, np.float32).ravel())
    if not 1 <= len(t) <= MAX_TAPS:
        raise ValueError(f"filtered_lrelu takes 1 to {MAX_TAPS} taps, got {len(t)}")
    return t


def _act(y: torch.Tensor, gain: float, slope: float, clamp: Optional[float]) -> torch.Tensor:
    y = F.leaky_relu(y, slope) if slope != 1 else y
    if gain != 1:
        y = y * gain
    if clamp is not None:
        y = y.clamp(-clamp, clamp)
    return y


def is_nhwc(x: torch.Tensor) -> bool:
    """Whether ``x`` is an NHWC (channels-last) batch that is not also a
    contiguous NCHW one (a batch of one channel or one pixel is both, and is
    taken as NCHW)."""
    return not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)


def _per_plane(s: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    """A scale of one value a plane, as (N, C, 1, 1) float32."""
    return None if s is None else s.float().reshape(x.shape[0], x.shape[1], 1, 1)


def filtered_lrelu_plain(x: torch.Tensor, fu, fd, b: Optional[torch.Tensor] = None,
                         up: int = 1, down: int = 1, pad=(0, 0), gain: float = 2 ** 0.5,
                         slope: float = 0.2, clamp: Optional[float] = None,
                         in_scale: Optional[torch.Tensor] = None,
                         out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version on ``x`` (N, C, H, W): in float32 on a contiguous
    NCHW copy, each filter as two 1-D passes of
    :func:`ops.upfirdn2d.upfirdn2d` (x then y); ``in_scale`` and
    ``out_scale`` (N, C) or None; returns ``x.dtype`` in x's layout (NHWC
    for an NHWC ``x``, with the same values)."""
    px0, px1, py0, py1 = normalize_pad(pad)
    fu_t = torch.tensor(_taps(fu), dtype=torch.float32) * up
    fd_t = torch.tensor(_taps(fd), dtype=torch.float32)
    y = x.contiguous().float()
    if in_scale is not None:
        y = y * _per_plane(in_scale, x)
    if b is not None:
        y = y + b.float().view(1, -1, 1, 1)
    y = upfirdn2d(y, fu_t.view(1, -1), up=(up, 1), pad=(px0, px1, 0, 0))
    y = upfirdn2d(y, fu_t.view(-1, 1), up=(1, up), pad=(0, 0, py0, py1))
    y = _act(y, gain, slope, clamp)
    y = upfirdn2d(y, fd_t.view(1, -1), down=(down, 1))
    y = upfirdn2d(y, fd_t.view(-1, 1), down=(1, down))
    if out_scale is not None:
        y = y * _per_plane(out_scale, x)
    y = y.to(x.dtype)
    return y.contiguous(memory_format=torch.channels_last) if is_nhwc(x) else y


# --- the launch plan ---------------------------------------------------------

class _K4Params(ctypes.Structure):
    """The C struct ``K4Params`` of ``csrc/filtered_lrelu.cu``."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "dtype", "nhwc", "up", "down", "planes", "channels", "in_h", "in_w", "out_h", "out_w",
        "py0", "px0", "nq", "kd", "th", "tw", "dy", "dx", "mh", "mw", "mh_used", "ih", "iw",
        "p_in", "p_hu", "p_mid", "p_hd", "slot", "off_hu", "off_mid", "off_out", "s_out",
        "cg", "lg", "gx", "gy", "gz", "pz", "runs", "smem_bytes")] + [
        ("gain", ctypes.c_float), ("slope", ctypes.c_float), ("clamp", ctypes.c_float),
        ("fu", ctypes.c_float * MAX_TAPS), ("fd", ctypes.c_float * MAX_TAPS)]


class K4Plan(NamedTuple):
    """Everything a K4 launch needs, made once per (input shape, layout,
    dtype, device, filters, up, down, pad, gain, slope, clamp): the output shape, the C arguments (``params``, passed by
    pointer; ``params.pz`` planes a block walks) and the planes a launch
    prefetches."""
    out_shape: Tuple[int, int, int, int]
    params: _K4Params
    device_index: int
    prefetched: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _odd(n: int) -> int:
    """A row pitch of at least ``n`` floats that is odd, so that the rows a
    warp's lanes walk down fall in different shared-memory banks."""
    return n | 1


def slot_words(iw: int, itemsize: int) -> int:
    """4-byte words a row of an NCHW input slot holds: ``iw`` elements from
    any element of a word on (a bf16 row may start on a word's second
    half)."""
    per = 4 // itemsize
    return _ceil(iw, per) + per - 1


def _banked(n: int, group: int) -> int:
    """At least ``n`` words, ``32 / group`` more than a multiple of 32: the
    stride between a group's slots (or staging tiles), so that the lanes of
    a warp, ``group`` channels of 32 / group neighbouring pixels, touch 32
    distinct banks."""
    return n + (32 // group - n) % 32


def tile_layout(up: int, down: int, nq: int, kd: int, pad, th: int, tw: int,
                itemsize: int = 4, group: int = 0):
    """The shared-memory tiles of one block (an output tile of ``th`` × ``tw``)
    for ``nq`` taps a phase of the up filter, ``kd`` of the down filter and
    input elements of ``itemsize`` bytes: the phase offsets (dy, dx) that put
    the upsampled tile's first row and column on phase 0, the upsampled tile
    (mh × mw, whole runs; ``mh_used`` rows feed the downsampling), the input
    tile (ih × iw), the odd row pitches (4-byte words) and the regions' word
    offsets: the input slots (``slot`` words apart), region B the
    x-upsampled tile and later the x-downsampled tile, region C the
    upsampled tile. ``group`` 0, an NCHW batch: two slots of the raw input
    as it lies in device memory (the plane being filtered and the next).
    ``group`` g ≥ 1, an NHWC batch: g slots of a word an element (a group of
    g channels), and g staging tiles of the output (``s_out`` words apart
    from ``off_out``): in the slots where an output tile fits one
    (``off_out`` 0), else after region C."""
    px0, _, py0, _ = normalize_pad(pad)
    dy, dx = (-py0) % up, (-px0) % up
    mh_used = dy + (th - 1) * down + kd
    mh = _ceil(mh_used, RUN) * RUN
    mw = _ceil(dx + (tw - 1) * down + kd, RUN) * RUN
    ih, iw = mh // up + nq, mw // up + nq
    p_in = _odd(iw if group else slot_words(iw, itemsize))
    p_hu, p_mid, p_hd = _odd(mw), _odd(mw), _odd(tw)
    slot = _banked(ih * p_in, group) if group else ih * p_in
    off_hu = (group or 2) * slot
    off_mid = off_hu + max(ih * p_hu, mh_used * p_hd)
    total = off_out = off_mid + mh * p_mid
    s_out = _banked(th * tw, group) if group else 0
    if group and th * tw <= ih * p_in:
        off_out, s_out = 0, slot
    elif group:
        total = off_out + (group - 1) * s_out + th * tw
    fmas = (ih * mw + mh * mw) * nq + (mh_used + th) * tw * kd
    return dict(group=group, nq=nq, dy=dy, dx=dx, mh=mh, mw=mw, mh_used=mh_used, ih=ih, iw=iw,
                p_in=p_in, p_hu=p_hu, p_mid=p_mid, p_hd=p_hd, slot=slot, off_hu=off_hu,
                off_mid=off_mid, off_out=off_out, s_out=s_out, smem_bytes=4 * total, th=th,
                tw=tw, fmas=fmas)


def choose_tile(out_h: int, out_w: int, up: int, down: int, nq: int, kd: int, pad,
                itemsize: int = 4, group: int = 0) -> dict:
    """The square tile of :data:`TILES` whose blocks do the fewest FMAs and
    loads over the whole plane (a tile's halo against the plane's ragged
    edge), within :data:`MAX_SMEM` (for an NHWC batch :data:`MAX_SMEM_NHWC`)
    with all its input slots (and, for an NHWC batch, its staging tiles);
    its :func:`tile_layout`. An NHWC group of which no tile fits is halved
    until one does."""
    best = None
    for t in TILES:
        lay = tile_layout(up, down, nq, kd, pad, t, t, itemsize, group)
        if lay["smem_bytes"] > (MAX_SMEM_NHWC if group else MAX_SMEM):
            continue
        cost = _ceil(out_h, t) * _ceil(out_w, t) * (lay["fmas"] + lay["ih"] * lay["iw"])
        if best is None or cost < best[0]:
            best = (cost, lay)
    if best is None and group > 1:
        return choose_tile(out_h, out_w, up, down, nq, kd, pad, itemsize, group // 2)
    return best[1]


def resident_blocks(smem_bytes: int) -> int:
    """Blocks of K4 an SM holds at once, by their shared memory."""
    return max(1, min(MAX_BLOCKS_SM, SM_SMEM // (smem_bytes + BLOCK_SMEM_RESERVED)))


def plane_walk(planes: int, tiles: int, smem_bytes: int) -> Tuple[int, int]:
    """(pz, gz): each block walks ``pz`` planes of its tile (the last block
    of a tile the rest), ``gz`` blocks a tile along the planes. ``pz`` is as
    large as keeps :data:`WAVES` full waves of blocks on the card (its SMs
    times :func:`resident_blocks`), at most :data:`MAX_WALK` (past it the
    block's set-up is paid off and the last wave's tail only grows), and at
    least 1; the planes are then shared out evenly among the ``gz``
    blocks."""
    wave = SMS * resident_blocks(smem_bytes)
    pz = max(1, min(MAX_WALK, planes * tiles // (WAVES * wave)), _ceil(planes, MAX_GRID_Z))
    gz = _ceil(planes, pz)
    return _ceil(planes, gz), gz


def channel_walk(n: int, c: int, tiles: int, smem_bytes: int,
                 group: int) -> Tuple[int, int, int]:
    """(pz, runs, gz) of an NHWC batch: a block's walk stays in one sample,
    so each sample's ``c`` channels are shared out among ``runs`` blocks a
    tile of about :func:`plane_walk`'s walk, ``pz`` each, a whole number of
    ``group``s (the last of a sample the rest); ``gz`` = n · runs blocks a
    tile along the planes."""
    runs = _ceil(c, plane_walk(n * c, tiles, smem_bytes)[0])
    pz = _ceil(_ceil(c, runs), group) * group
    runs = _ceil(c, pz)
    return pz, runs, n * runs


# (up, down, taps a phase of fu, taps of fd) that the kernel has its own
# instantiation of: the published StyleGAN3 layers; any other count runs
# zero-padded to 24 taps
SPECIALIZED = ((2, 2, 6, 12), (4, 2, 6, 12), (1, 1, 1, 1))


def instantiated_taps(up: int, down: int, ku: int, kd: int) -> Tuple[int, int]:
    """(taps a phase of the up filter, taps of the down filter) of the
    kernel instantiation that runs these filters."""
    nq = _ceil(ku, up)
    if (up, down, nq, kd) in SPECIALIZED:
        return nq, kd
    return MAX_TAPS // up, MAX_TAPS


def phase_taps(fu: Sequence[float], up: int) -> np.ndarray:
    """The up filter flipped (a true convolution), times ``up`` (the gain of
    one axis), split by phase: row ``ph`` holds the taps ``ph + up·q``,
    q < 24 / up, zero past the end. The kernel reads row ``ph`` at
    ``ph · 24 / up``."""
    f = np.asarray(fu, np.float32)[::-1] * up
    out = np.zeros((up, MAX_TAPS // up), np.float32)
    for ph in range(up):
        taps = f[ph::up]
        out[ph, :len(taps)] = taps
    return out


def make_plan(in_shape, dtype: torch.dtype, device: torch.device, fu, fd, up: int,
              down: int, pad, gain: float, slope: float, clamp: Optional[float],
              what: str = "filtered_lrelu_cuda", nhwc: bool = False) -> K4Plan:
    """The launch plan of K4 for an input of ``in_shape`` (N, C, H, W), NCHW
    or (``nhwc``) channels-last; raises on what the kernel does not take."""
    if device.type != "cuda":
        raise ValueError(f"{what} takes a CUDA tensor")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} takes float32 or bfloat16, got {dtype}")
    if len(in_shape) != 4:
        raise ValueError(f"{what} takes a contiguous NCHW or NHWC tensor")
    if up not in _UPS or down not in _DOWNS:
        raise ValueError(f"{what} takes up in {_UPS} and down in {_DOWNS}, got {(up, down)}")
    fu, fd = _taps(fu), _taps(fd)
    n, c, h, w = (int(d) for d in in_shape)
    out_h, out_w = output_shape(h, w, len(fu), len(fd), up, down, pad)
    if out_h < 1 or out_w < 1:
        raise ValueError(f"{what}: empty output {out_h}x{out_w}")
    px0, _, py0, _ = normalize_pad(pad)
    nq, kd = instantiated_taps(up, down, len(fu), len(fd))
    itemsize = torch.empty((), dtype=dtype).element_size()
    lay = choose_tile(out_h, out_w, up, down, nq, kd, pad, itemsize, GROUP if nhwc else 0)
    gx, gy = _ceil(out_w, lay["tw"]), _ceil(out_h, lay["th"])
    if nhwc:
        # a pixel's offset within its sample is counted in 32 bits
        if max((h + lay["ih"]) * (w + lay["iw"]), out_h * out_w) * c >= 2 ** 31:
            raise ValueError(f"{what}: a sample of {c}x{h}x{w} is too large for NHWC")
        pz, runs, gz = channel_walk(n, c, gx * gy, lay["smem_bytes"], lay["group"])
    else:
        (pz, gz), runs = plane_walk(n * c, gx * gy, lay["smem_bytes"]), 1
    if gz > MAX_GRID_Z:
        raise ValueError(f"{what}: {gz} blocks a tile along the planes")
    taps_u = np.zeros(MAX_TAPS, np.float32)
    taps_u[:] = phase_taps(fu, up).ravel()
    taps_d = np.zeros(MAX_TAPS, np.float32)
    taps_d[:len(fd)] = np.asarray(fd, np.float32)[::-1]
    cg = max(lay["group"], 1)
    params = _K4Params(
        dtype=_DTYPE_CODE[dtype], nhwc=int(nhwc), up=up, down=down, planes=n * c, channels=c,
        in_h=h, in_w=w, out_h=out_h, out_w=out_w, py0=py0, px0=px0, nq=nq, kd=kd,
        **{k: lay[k] for k in ("th", "tw", "dy", "dx", "mh", "mw", "mh_used", "ih", "iw",
                               "p_in", "p_hu", "p_mid", "p_hd", "slot", "off_hu", "off_mid",
                               "off_out", "s_out", "smem_bytes")},
        cg=cg, lg=cg.bit_length() - 1, gx=gx, gy=gy, gz=gz, pz=pz, runs=runs,
        gain=float(gain), slope=float(slope), clamp=-1.0 if clamp is None else float(clamp),
        fu=(ctypes.c_float * MAX_TAPS)(*taps_u.tolist()),
        fd=(ctypes.c_float * MAX_TAPS)(*taps_d.tolist()))
    return K4Plan((n, c, out_h, out_w), params,
                  device.index if device.index is not None else torch.cuda.current_device(),
                  gx * gy * (n * c - gz))


_plans: Dict[tuple, K4Plan] = {}


def plan_for(x: torch.Tensor, fu, fd, up: int, down: int, pad, gain: float, slope: float,
             clamp: Optional[float]) -> K4Plan:
    """The cached plan for input ``x`` (made on its first call, counted in
    ``filtered_lrelu_cuda.plan_misses``), keyed by its shape and layout."""
    nhwc = is_nhwc(x)
    key = (tuple(fu), tuple(fd), up, down, tuple(pad), float(gain), float(slope), clamp,
           x.shape, nhwc, x.dtype, x.device)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = make_plan(tuple(x.shape), x.dtype, x.device, fu, fd, up, down,
                                       pad, gain, slope, clamp, nhwc=nhwc)
        filtered_lrelu_cuda.plan_misses += 1
    return plan


def _ptr(t: Optional[torch.Tensor], n: int, x: torch.Tensor, what: str) -> Optional[int]:
    """The pointer of a float32 vector of ``n`` values on x's device (None: a
    null pointer); raises on anything else."""
    if t is None:
        return None
    if t.dtype != torch.float32 or t.numel() != n or t.device != x.device or \
            not t.is_contiguous():
        raise ValueError(f"filtered_lrelu_cuda takes {what} as {n} contiguous float32 values "
                         "on the input's device")
    return t.data_ptr()


def _launch(x, b, fu, fd, up, down, pad, gain, slope, clamp, in_scale=None,
            out_scale=None) -> torch.Tensor:
    nhwc = is_nhwc(x)
    if not (nhwc or x.is_contiguous()):
        raise ValueError("filtered_lrelu_cuda takes a contiguous NCHW or NHWC tensor")
    plan = plan_for(x, fu, fd, up, down, pad, gain, slope, clamp)
    planes = x.shape[0] * x.shape[1]
    b_ptr = _ptr(b, x.shape[1], x, "the bias")
    y = torch.empty(plan.out_shape, dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last if nhwc else torch.contiguous_format)
    with on_card_of(x):
        check(load_library().filtered_lrelu_run(
            ctypes.byref(plan.params), x.data_ptr(), b_ptr,
            _ptr(in_scale, planes, x, "in_scale"), _ptr(out_scale, planes, x, "out_scale"),
            y.data_ptr(), torch._C._cuda_getCurrentRawStream(plan.device_index)),
            "filtered_lrelu_cuda")
    filtered_lrelu_cuda.launches += 1
    filtered_lrelu_cuda.nhwc_launches += nhwc
    filtered_lrelu_cuda.prefetched_planes += plan.prefetched
    return y


def filtered_lrelu_cuda(x: torch.Tensor, fu, fd, b: torch.Tensor, up: int, down: int, pad,
                        gain: float, slope: float, clamp: Optional[float],
                        in_scale: Optional[torch.Tensor] = None,
                        out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K4 on a contiguous NCHW or NHWC CUDA tensor (f32 or bf16) with a
    float32 bias (C,) and float32 scales (N, C) or None; the output takes the
    input's layout."""
    return _launch(x, b, _taps(fu), _taps(fd), int(up), int(down),
                   normalize_pad(pad), gain, slope, clamp, in_scale, out_scale)


filtered_lrelu_cuda.launches = 0
filtered_lrelu_cuda.nhwc_launches = 0
filtered_lrelu_cuda.plan_misses = 0
filtered_lrelu_cuda.prefetched_planes = 0


# --- the operator ---------------------------------------------------------------

def _plain_op(x, b, fu, fd, up, down, pad, gain, slope, clamp, in_scale, out_scale):
    return filtered_lrelu_plain(x, fu, fd, b, up, down, tuple(pad), gain, slope, clamp,
                                in_scale, out_scale)


def _cuda_op(x, b, fu, fd, up, down, pad, gain, slope, clamp, in_scale, out_scale):
    return _launch(x, b, tuple(fu), tuple(fd), up, down, tuple(pad), gain, slope, clamp,
                   in_scale, out_scale)


def _fake_op(x, b, fu, fd, up, down, pad, gain, slope, clamp, in_scale, out_scale):
    n, c, h, w = x.shape
    oh, ow = output_shape(h, w, len(fu), len(fd), up, down, tuple(pad))
    if is_nhwc(x):
        return x.new_empty_strided((n, c, oh, ow), (oh * ow * c, 1, ow * c, c))
    return x.new_empty((n, c, oh, ow))


# K4 as a registered operator: ``fu``/``fd`` the 1-D taps (not flipped),
# ``pad`` (px0, px1, py0, py1), ``clamp`` None for none, the scales (N, C)
filtered_lrelu_op = register_op(
    "filtered_lrelu(Tensor x, Tensor b, float[] fu, float[] fd, int up, int down, int[] pad, "
    "float gain, float slope, float? clamp, Tensor? in_scale, Tensor? out_scale) -> Tensor",
    _plain_op, _cuda_op, _fake_op)


def filtered_lrelu(x: torch.Tensor, fu, fd, b: Optional[torch.Tensor] = None, up: int = 1,
                   down: int = 1, pad=(0, 0), gain: float = 2 ** 0.5, slope: float = 0.2,
                   clamp: Optional[float] = None, in_scale: Optional[torch.Tensor] = None,
                   out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The filtered leaky ReLU of ``x`` (N, C, H, W) through
    ``sdfr::filtered_lrelu``: K4 for a CUDA tensor (an NHWC one as it is,
    any other made contiguous NCHW), the plain version for a CPU tensor; the
    output in x's layout. ``fu``/``fd``: 1-D taps (tensors, arrays or
    sequences) or None; ``in_scale``/``out_scale``: (N, C) per-plane scales
    or None."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"filtered_lrelu runs on cuda or cpu, not {x.device}")
    if x.is_cuda and not is_nhwc(x):
        x = x.contiguous()
    bias = (torch.zeros(x.shape[1], device=x.device) if b is None
            else b.to(device=x.device, dtype=torch.float32))
    def scale(s):
        return None if s is None else s.to(device=x.device, dtype=torch.float32).contiguous()

    return filtered_lrelu_op(x, bias, list(_taps(fu)), list(_taps(fd)), int(up), int(down),
                             list(normalize_pad(pad)), float(gain), float(slope),
                             None if clamp is None else float(clamp), scale(in_scale),
                             scale(out_scale))
