"""K3: the FAN dense-residual ConvBlock for channels-equal 256-channel blocks.

    o1 = conv3x3(relu(x * i1 + f1))       256 → 128
    o2 = conv3x3(relu(o1 * i2 + f2))      128 → 64
    o3 = conv3x3(relu(o2 * i3 + f3))       64 → 64
    out = concat(o1, o2, o3) + x

on NCHW x (B, 256, H, W), float32 or bf16. The folds come from
:func:`..models.nn.fold_bn` (f32, rounded to the activation dtype); sums
are f32 and each stage's output is rounded to the activation dtype.

Replaces the Pallas TPU kernel ``stylegan_directions_face_reenactment_tpu/
ops/fused_conv_block.py::_forward`` (entered through ``fused_conv_block_256``
and ``conv_block_fused``; gate ``fused_convblock_enabled``). On the serving
path every hourglass block and ``top_m`` of FAN's 4 modules takes it: 14
blocks a module, 56 a FAN pass, 112 a request of the fused default path
(two FAN passes).

Bound on an H100: operations, 811,008 FLOP a block-pixel against 2 KB of
f32 activations (about 400 FLOP a byte). ``csrc/fused_conv_block.cu`` says
what its design does about that: a prologue pass writes the first stage's
activation channels-innermost, and each stage is an implicit GEMM (``wgmma``
in bf16, register-blocked FMAs in float32) over the pixels of all images
whose epilogue writes its slice of ``out`` and the next stage's activation.
:func:`schedule` is the table that splits a small map's K loop across
blocks; :func:`scratch_layout` places the activations and the split-K
partials in one scratch buffer that the wrapper allocates.

The gate: :func:`fused_convblock_enabled` takes every channels-equal
256-channel block on a CUDA tensor, at every size from 64² down to 4², in
both dtypes: the JAX gate's 16 MB VMEM budget and its 8×8 floor are limits
of the TPU and do not carry over. CPU tensors take the plain version.

* :func:`fused_conv_block_plain` is the plain PyTorch version (fold → ReLU
  → ``F.conv2d`` three times, cat, + x); :func:`fused_conv_block` takes it
  only for CPU tensors.
* :func:`fused_conv_block_cuda` launches the kernel and counts its launches
  in ``fused_conv_block_cuda.launches`` (one a block; the kernel runs as a
  prologue and three stage launches, each split stage with its reduce
  pass).
* Where ``x`` or a fold or weight needs a gradient, :func:`fused_conv_block`
  runs the kernel inside an autograd Function whose backward
  (:func:`fused_conv_block_bwd`) recomputes the plain version from the saved
  inputs and differentiates it, as the JAX package's custom VJP
  (``fused_conv_block_256``'s ``_bwd``: ``jax.vjp`` of ``_reference``, no
  Pallas call); on the card that is autograd through cuDNN. It counts its
  calls in ``fused_conv_block_bwd.launches``.
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .kernel_build import check, load_library, on_card_of

CHANNELS = 256
_ENTRY = {torch.float32: "fused_conv_block_f32", torch.bfloat16: "fused_conv_block_bf16"}

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class K3Args(NamedTuple):
    """A block's folds and weights in the activation dtype: ``w`` OIHW (the
    plain version's), ``wk`` the kernel's packing (:func:`kernel_weight`)."""
    inv: Tensors3
    off: Tensors3
    w: Tensors3
    wk: Tensors3


def fused_convblock_enabled(p, x: torch.Tensor) -> bool:
    """Whether ConvBlock ``p`` takes the kernel for ``x``: a channels-equal
    256-channel block (no downsample) on an NCHW CUDA tensor."""
    return (x.is_cuda and getattr(p, "downsample", None) is None and x.dim() == 4
            and x.shape[1] == CHANNELS)


def kernel_weight(w: torch.Tensor) -> torch.Tensor:
    """An OIHW 3×3 weight in the kernel's layout: float32 (cin, 3, 3, cout),
    a K step's 16 input channels × 64 output channels as rows of contiguous
    output channels; bf16 (9, cin / 64, cout, 64), one (tap, 64-channel
    chunk) slab a K step, each output channel's 64 input channels one
    128-byte row (``wgmma``'s K-major B operand)."""
    if w.dtype == torch.bfloat16:
        cout, cin = w.shape[:2]
        return w.reshape(cout, cin // 64, 64, 9).permute(3, 1, 0, 2).contiguous()
    return w.permute(1, 2, 3, 0).contiguous()


def _kernel_weight_shape(cin: int, cout: int, dtype: torch.dtype) -> Tuple[int, ...]:
    return (9, cin // 64, cout, 64) if dtype == torch.bfloat16 else (cin, 3, 3, cout)


# --- the schedule table ------------------------------------------------------

STAGES = ((256, 128), (128, 64), (64, 64))   # (cin, cout) of the three stages
TILE_M = 128                                 # pixels of a block tile
SMS = 132                                    # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 36                              # more partials cost more than they spread


def target_blocks(dtype: torch.dtype) -> int:
    """The blocks a stage with few tiles is split to put on the card: one an
    SM in bf16, two in float32 (its 128-thread blocks fit three an SM, but
    more partials cost more than the third gains). Chosen from split sweeps
    on the H100 (``tune_k3_splits.py``)."""
    return SMS if dtype == torch.bfloat16 else 2 * SMS


def full_wave(dtype: torch.dtype) -> int:
    """Tiles from which a stage runs unsplit: three quarters of its target."""
    return 3 * target_blocks(dtype) // 4


def tile_n(cout: int, dtype: torch.dtype) -> int:
    """Output channels of a block tile: 128 for bf16's 128-channel first
    stage (``wgmma`` m64n128), 64 otherwise."""
    return 128 if dtype == torch.bfloat16 and cout == 128 else 64


def k_step_channels(dtype: torch.dtype) -> int:
    """Input channels of one K step (a K step is one tap of that many
    channels): 64 in bf16 (a 128-byte ``wgmma`` row), 16 in float32."""
    return 64 if dtype == torch.bfloat16 else 16


class K3Schedule(NamedTuple):
    """How K3 runs on a (batch, 256, h, w) input, per stage: the K steps a
    block sums (``kchunk``; all of them when unsplit), the splits and the
    blocks; and the f32 elements of split-K partials the largest split
    stage needs (0 when no stage splits)."""
    kchunk: Tuple[int, int, int]
    splits: Tuple[int, int, int]
    blocks: Tuple[int, int, int]
    workspace: int


@functools.lru_cache(maxsize=None)
def schedule(batch: int, h: int, w: int, dtype: torch.dtype) -> K3Schedule:
    """The schedule table. M = batch·h·w pixels in tiles of 128. A stage
    whose tiles reach :func:`full_wave` runs unsplit; a smaller one splits
    its K steps into chunks of ``ksteps // ceil(target / tiles)`` (at least
    one, at most ``MAX_SPLITS`` splits), so that it puts about
    :func:`target_blocks` blocks on the card, and its partials are summed by
    a second pass in split order."""
    m = batch * h * w
    m_tiles = -(-m // TILE_M)
    kchunk, splits, blocks, ws = [], [], [], 0
    for cin, cout in STAGES:
        tiles = m_tiles * (cout // tile_n(cout, dtype))
        ksteps = 9 * cin // k_step_channels(dtype)
        if tiles >= full_wave(dtype):
            chunk = ksteps
        else:
            chunk = max(-(-ksteps // MAX_SPLITS), ksteps // -(-target_blocks(dtype) // tiles), 1)
        n_split = -(-ksteps // chunk)
        kchunk.append(chunk)
        splits.append(n_split)
        blocks.append(tiles * n_split)
        if n_split > 1:
            ws = max(ws, n_split * m * cout)
    return K3Schedule(tuple(kchunk), tuple(splits), tuple(blocks), ws)


def make_k3_args(inv, off, w, dtype: torch.dtype) -> K3Args:
    """K3Args from three folds each of (inv, off) and three OIHW weights."""
    w = tuple(t.to(dtype) for t in w)
    return K3Args(tuple(t.to(dtype) for t in inv), tuple(t.to(dtype) for t in off),
                  w, tuple(kernel_weight(t) for t in w))


_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def block_args(p, dtype: torch.dtype) -> K3Args:
    """ConvBlock ``p``'s K3Args in ``dtype``. They are kept beside ``p`` and
    rebuilt when a weight or statistic changes (its storage or version),
    unless a gradient is to reach the parameters (grad on and a parameter
    that requires it): then they are built anew each call. A frozen FAN
    (training's) keeps its args with grad on too, so its served calls hit
    the launch cache."""
    from ..models.nn import fold_bn
    tensors = list(p.parameters()) + list(p.buffers())

    def build():
        folds = [fold_bn(bn, dtype) for bn in (p.bn1, p.bn2, p.bn3)]
        return make_k3_args([f[0] for f in folds], [f[1] for f in folds],
                            [p.conv1.weight, p.conv2.weight, p.conv3.weight], dtype)

    if (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)) or any(
            t.is_inference() for t in tensors):
        return build()
    key = (dtype, tensors[0].device,
           tuple((t.data_ptr(), t._version) for t in tensors))
    entry = _cache.get(p)
    if entry is None or entry[0] != key:
        entry = (key, build())
        _cache[p] = entry
    return entry[1]


def fused_conv_block_plain(x: torch.Tensor, args: K3Args) -> torch.Tensor:
    """Plain version: the same arithmetic as three PyTorch stages."""
    outs, h = [], x
    for inv, off, w in zip(args.inv, args.off, args.w):
        act = torch.clamp_min(h * inv.view(1, -1, 1, 1) + off.view(1, -1, 1, 1), 0)
        h = F.conv2d(act, w, padding=1)
        outs.append(h)
    return torch.cat(outs, dim=1) + x


def _check(x: torch.Tensor, args: K3Args) -> None:
    if not x.is_cuda:
        raise ValueError("fused_conv_block_cuda takes a CUDA tensor")
    if x.dtype not in _ENTRY:
        raise TypeError(f"fused_conv_block_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] != CHANNELS or x.numel() == 0:
        raise ValueError(f"fused_conv_block_cuda takes a non-empty (B, {CHANNELS}, H, W) "
                         f"tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("fused_conv_block_cuda takes a contiguous NCHW tensor")
    cin = (256, 128, 64)
    cout = (128, 64, 64)
    for k in range(3):
        for t, shape in ((args.inv[k], (cin[k],)), (args.off[k], (cin[k],)),
                         (args.wk[k], _kernel_weight_shape(cin[k], cout[k], x.dtype))):
            if tuple(t.shape) != shape or t.dtype != x.dtype or t.device != x.device \
                    or not t.is_contiguous():
                raise ValueError(f"stage {k + 1}: expected a contiguous {shape} {x.dtype} "
                                 f"tensor on {x.device}, got {tuple(t.shape)} {t.dtype} "
                                 f"on {t.device}")


def scratch_layout(batch: int, h: int, w: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """Byte offsets in K3's one scratch buffer of the NHWC activations
    A1 (then A3) and A2 and of the split-K partials, and its size:
    ``(act_b, ws, total)`` (A1 at 0), each part 256-byte aligned."""
    m, es = batch * h * w, torch.empty((), dtype=dtype).element_size()

    def up(n):
        return -(-n // 256) * 256
    act_b = up(m * 256 * es)
    ws = act_b + up(m * 128 * es)
    return act_b, ws, ws + 4 * schedule(batch, h, w, dtype).workspace


class _Launch(NamedTuple):
    """A checked K3 launch for one (args, input shape, dtype, device): the C
    entry point, the weight and fold pointers, the scratch layout and the
    schedule's K steps a block. ``args`` is kept so that its id stays
    unique while the entry lives."""
    args: K3Args
    fn: object
    ptrs: Tuple[int, ...]
    layout: Tuple[int, int, int]
    kchunk: Tuple[int, int, int]


_launches: dict = {}


def _launch_for(x: torch.Tensor, args: K3Args, keep: bool) -> _Launch:
    key = (id(args), x.shape, x.dtype, x.device)
    hit = _launches.get(key)
    if hit is not None and hit.args is args:
        return hit
    _check(x, args)
    b, _, h, w = x.shape
    ptrs = []
    for k in range(3):
        ptrs += [args.inv[k].data_ptr(), args.off[k].data_ptr(), args.wk[k].data_ptr()]
    hit = _Launch(args, getattr(load_library(), _ENTRY[x.dtype]), tuple(ptrs),
                  scratch_layout(b, h, w, x.dtype), schedule(b, h, w, x.dtype).kchunk)
    if keep:
        if len(_launches) >= 1024:     # args of blocks whose weights changed
            _launches.clear()
        _launches[key] = hit
    return hit


def fused_conv_block_cuda(x: torch.Tensor, args: K3Args, keep: bool = True) -> torch.Tensor:
    """Launch K3 on a contiguous (B, 256, H, W) CUDA tensor (f32 or bf16).
    The checks of ``args`` run on the first call of a shape; a call then
    allocates the output and the scratch and makes one C call. ``keep``
    False checks the args anew and keeps no entry for them: args built
    for one autograd call."""
    if not x.is_contiguous():
        raise ValueError("fused_conv_block_cuda takes a contiguous NCHW tensor")
    run = _launch_for(x, args, keep)
    b, _, h, w = x.shape
    out = torch.empty_like(x)
    act_b, ws, total = run.layout
    scratch = torch.empty(total, dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    with on_card_of(x):
        status = run.fn(x.data_ptr(), *run.ptrs, out.data_ptr(), base, base + act_b,
                        base + ws, b, h, w, *run.kchunk,
                        torch._C._cuda_getCurrentRawStream(x.device.index))
    check(status, "fused_conv_block_cuda")
    fused_conv_block_cuda.launches += 1
    return out


fused_conv_block_cuda.launches = 0


def fused_conv_block_bwd(grad: torch.Tensor, x: torch.Tensor, args: K3Args,
                         needs: Tuple[bool, ...]) -> Tuple:
    """K3's backward: the gradients of ``x`` and of the three folds' scales,
    the three folds' offsets and the three weights (in that order; None
    where ``needs``, ten flags in the same order, says none is wanted),
    from the plain version recomputed on detached copies of the inputs."""
    leaves = [t.detach().requires_grad_(n)
              for t, n in zip((x,) + args.inv + args.off + args.w, needs)]
    with torch.enable_grad():
        out = fused_conv_block_plain(
            leaves[0], K3Args(tuple(leaves[1:4]), tuple(leaves[4:7]),
                              tuple(leaves[7:10]), args.wk))
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad))
    fused_conv_block_bwd.launches += 1
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


fused_conv_block_bwd.launches = 0


class _FusedConvBlockCUDA(torch.autograd.Function):
    """K3 forward; the backward is :func:`fused_conv_block_bwd`. Inputs: x,
    the block's K3Args, then its three scales, offsets and weights again as
    tensors, so that autograd sees them (the packed weights ``wk`` take no
    gradient of their own: theirs reaches ``w``)."""

    @staticmethod
    def forward(ctx, x, args, *tensors):
        ctx.save_for_backward(x, *tensors)
        ctx.wk = args.wk
        return fused_conv_block_cuda(x, args, keep=False)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, *t = ctx.saved_tensors
        args = K3Args(tuple(t[0:3]), tuple(t[3:6]), tuple(t[6:9]), ctx.wk)
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[2:]
        grads = fused_conv_block_bwd(grad.contiguous(), x, args, needs)
        return (grads[0], None) + grads[1:]


def fused_conv_block(x: torch.Tensor, args: K3Args) -> torch.Tensor:
    """The block: the kernel for a CUDA tensor (inside an autograd Function
    when a gradient is wanted), the plain version for a CPU tensor."""
    if x.is_cuda:
        x = x.contiguous()
        if torch.is_grad_enabled() and (x.requires_grad or any(
                t.requires_grad for t in args.inv + args.off + args.w)):
            return _FusedConvBlockCUDA.apply(x, args, *args.inv, *args.off, *args.w)
        return fused_conv_block_cuda(x, args)
    if x.device.type != "cpu":
        raise ValueError(f"fused_conv_block runs on cuda or cpu, not {x.device}")
    return fused_conv_block_plain(x, args)


def conv_block_fused(p, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``models/face/fan.py::conv_block`` on a channels-equal
    256-channel ConvBlock ``p``."""
    return fused_conv_block(x, block_args(p, x.dtype))
