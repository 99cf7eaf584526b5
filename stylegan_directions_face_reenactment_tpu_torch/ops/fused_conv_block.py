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
f32 activations (about 400 FLOP a byte). float32 runs three TF32 products
for each product (``a_hi·b_hi + a_hi·b_lo + a_lo·b_hi``, each operand split
into ``hi = tf32(v)`` and ``lo = tf32(v − hi)``), so that it holds to f32
tolerance: its floor is 3 × 811,008 FLOP a block-pixel at the TF32 dense
rate, 495 TFLOP/s. ``csrc/fused_conv_block.cu`` says what its design does
about that: a prologue pass writes the first stage's activation
channels-innermost, and each stage is an implicit GEMM on the tensor cores
(``wgmma``, bf16 or TF32) over the pixels of all images whose epilogue
writes its slice of ``out`` and the next stage's activation. In float32
the splits are made where the operands are written: the activations as a
hi and a lo plane, the weights once, when they are packed
(:func:`kernel_weight`).
:func:`schedule` is the table that splits a small map's K loop across
blocks; :func:`scratch_layout` places the activations and the split-K
partials in one scratch buffer that the wrapper allocates.

The gate: :func:`fused_convblock_enabled` takes every block
:func:`k3_takes` (channels-equal, 256 channels) on a CUDA tensor, at every
size from 64² down to 4², in both dtypes: the JAX gate's 16 MB VMEM budget
and its 8×8 floor are limits of the TPU and do not carry over. CPU tensors
take the plain version.

* :func:`fused_conv_block_plain` is the plain PyTorch version (fold → ReLU
  → ``F.conv2d`` three times, cat, + x).
* ``sdfr::fused_conv_block`` (``fused_conv_block_op``) is the
  registered operator that :func:`fused_conv_block`, the eager paths and
  an exported graph call, on x and the block's twelve K3Args tensors: the
  plain version on a CPU tensor, the kernel on a CUDA tensor, shapes alone
  under fake tensors.
* :func:`fused_conv_block_cuda` checks its arguments and launches the
  kernel on every call, and counts its launches in
  ``fused_conv_block_cuda.launches`` (one a block; the kernel runs as a
  prologue and three stage launches, each split stage with its reduce
  pass). What a launch needs besides its tensors is a :class:`K3Plan`, made
  once per input shape by :func:`plan_for` and counted in
  ``fused_conv_block_cuda.plan_misses``.
* :func:`conv_block_args` makes a ConvBlock's K3Args; :func:`block_args`
  keeps them beside the block and counts in ``fused_conv_block.args_built``
  each time it makes them anew.
* The operator's autograd formula (:func:`fused_conv_block_bwd`)
  recomputes the plain version from the saved inputs and differentiates
  it, as the JAX package's custom VJP (``fused_conv_block_256``'s ``_bwd``:
  ``jax.vjp`` of ``_reference``, no Pallas call); on the card that is
  autograd through cuDNN. It counts its calls in
  ``fused_conv_block_bwd.launches``.
* :func:`program_args` hands a program's own K3Args (made once, among its
  weights) to FAN's blocks, on every device.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .kernel_build import check, load_library, on_card_of, register_autograd, register_op

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


def k3_takes(p) -> bool:
    """Whether K3 takes ConvBlock ``p``: no downsample, 256 channels in and
    out."""
    return p.downsample is None and p.bn1.num_features == CHANNELS


def fused_convblock_enabled(p, x: torch.Tensor) -> bool:
    """Whether ConvBlock ``p`` takes the kernel for ``x``: a block
    :func:`k3_takes`, on a 4-D CUDA tensor."""
    return x.is_cuda and x.dim() == 4 and k3_takes(p)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``v`` as ``(hi, lo)``: ``hi = tf32(v)`` (10 mantissa bits, the
    low 13 bits zero, ties away from zero as ``cvt.rna.tf32.f32``) and ``lo =
    tf32(v − hi)``, so ``hi + lo`` is ``v`` within 2^-21·|v|."""
    def tf32(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = tf32(v)
    return hi, tf32(v - hi)


def kernel_weight(w: torch.Tensor) -> torch.Tensor:
    """An OIHW 3×3 weight in the kernel's layout, one K-major slab a K step
    (tap, channel chunk), each output channel's chunk one 128-byte row
    (``wgmma``'s B operand): bf16 (9, cin / 64, cout, 64); float32 split
    into its TF32 hi and lo parts (:func:`tf32_split`), (9, cin / 32, 2,
    cout, 32), a step's cout hi rows and then its cout lo rows."""
    cout, cin = w.shape[:2]
    kc = k_step_channels(w.dtype)

    def slabs(t):
        return t.reshape(cout, cin // kc, kc, 9).permute(3, 1, 0, 2)
    if w.dtype == torch.bfloat16:
        return slabs(w).contiguous()
    hi, lo = tf32_split(w)
    return torch.stack((slabs(hi), slabs(lo)), dim=2).contiguous()


def _kernel_weight_shape(cin: int, cout: int, dtype: torch.dtype) -> Tuple[int, ...]:
    kc = k_step_channels(dtype)
    return (9, cin // kc, cout, kc) if dtype == torch.bfloat16 else (9, cin // kc, 2, cout, kc)


# --- the schedule table ------------------------------------------------------

STAGES = ((256, 128), (128, 64), (64, 64))   # (cin, cout) of the three stages
TILE_M = 128                                 # pixels of a block tile
SMS = 132                                    # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 36                              # more partials cost more than they spread


def target_blocks(dtype: torch.dtype) -> int:
    """The blocks a stage with few tiles is split to put on the card: one an
    SM in bf16; in float32, whose ring of hi and lo slots fills an SM's
    shared memory, 128, so that a 32-tile stage splits 4 ways and not 6
    (the partials cost more than the last few SMs gain). Chosen from split
    sweeps on the H100 (``tune_k3_splits.py``)."""
    return SMS if dtype == torch.bfloat16 else 128


def full_wave(dtype: torch.dtype) -> int:
    """Tiles from which a stage runs unsplit: three quarters of its target."""
    return 3 * target_blocks(dtype) // 4


def k_step_channels(dtype: torch.dtype) -> int:
    """Input channels of one K step (a K step is one tap of that many
    channels): one 128-byte ``wgmma`` row, 64 in bf16 and 32 in float32."""
    return 64 if dtype == torch.bfloat16 else 32


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
        tiles = m_tiles     # a tile spans the stage's output channels, in both dtypes
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


def conv_block_args(p, dtype: torch.dtype) -> K3Args:
    """ConvBlock ``p``'s K3Args in ``dtype``: its three batch norms folded
    (:func:`..models.nn.fold_bn`) and its three weights."""
    from ..models.nn import fold_bn
    folds = [fold_bn(bn, dtype) for bn in (p.bn1, p.bn2, p.bn3)]
    return make_k3_args([f[0] for f in folds], [f[1] for f in folds],
                        [p.conv1.weight, p.conv2.weight, p.conv3.weight], dtype)


_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def block_args(p, dtype: torch.dtype) -> K3Args:
    """ConvBlock ``p``'s K3Args in ``dtype`` (:func:`conv_block_args`). They
    are kept beside ``p`` and rebuilt when a weight or statistic changes
    (its storage or version), unless a gradient is to reach the parameters
    (grad on and a parameter that requires it): then they are built anew
    each call. A frozen FAN (training's) keeps its args with grad on too."""
    tensors = list(p.parameters()) + list(p.buffers())

    def build():
        fused_conv_block.args_built += 1
        return conv_block_args(p, dtype)

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
    ``(act_b, ws, total)`` (A1 at 0), each part 256-byte aligned. A float32
    activation is two planes, its TF32 hi and lo parts."""
    m, es = batch * h * w, torch.empty((), dtype=dtype).element_size()
    planes = 1 if dtype == torch.bfloat16 else 2

    def up(n):
        return -(-n // 256) * 256
    act_b = up(planes * m * 256 * es)
    ws = act_b + up(planes * m * 128 * es)
    return act_b, ws, ws + 4 * schedule(batch, h, w, dtype).workspace


class K3Plan(NamedTuple):
    """What a K3 launch needs besides its tensors, made once per (input
    shape, dtype, device): the C entry point, the scratch layout
    (:func:`scratch_layout`) and the schedule's K steps a block."""
    fn: object
    layout: Tuple[int, int, int]
    kchunk: Tuple[int, int, int]


_plans: Dict[tuple, K3Plan] = {}


def plan_for(x: torch.Tensor) -> K3Plan:
    """The cached plan for input ``x`` (made on its first call, counted in
    ``fused_conv_block_cuda.plan_misses``)."""
    key = (x.shape, x.dtype, x.device)
    plan = _plans.get(key)
    if plan is None:
        b, _, h, w = x.shape
        plan = _plans[key] = K3Plan(getattr(load_library(), _ENTRY[x.dtype]),
                                    scratch_layout(b, h, w, x.dtype),
                                    schedule(b, h, w, x.dtype).kchunk)
        fused_conv_block_cuda.plan_misses += 1
    return plan


def fused_conv_block_cuda(x: torch.Tensor, args: K3Args) -> torch.Tensor:
    """Launch K3 on a contiguous (B, 256, H, W) CUDA tensor (f32 or bf16).
    A call checks ``args`` against ``x``, takes the plan of x's shape
    (:func:`plan_for`), allocates the output and the scratch and makes one
    C call."""
    _check(x, args)
    plan = plan_for(x)
    b, _, h, w = x.shape
    out = torch.empty_like(x)
    act_b, ws, total = plan.layout
    scratch = torch.empty(total, dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    ptrs = [t.data_ptr() for k in range(3) for t in (args.inv[k], args.off[k], args.wk[k])]
    with on_card_of(x):
        status = plan.fn(x.data_ptr(), *ptrs, out.data_ptr(), base, base + act_b, base + ws,
                         b, h, w, *plan.kchunk,
                         torch._C._cuda_getCurrentRawStream(x.device.index))
    check(status, "fused_conv_block_cuda")
    fused_conv_block_cuda.launches += 1
    return out


fused_conv_block_cuda.launches = 0
fused_conv_block_cuda.plan_misses = 0


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


# --- the operator: what the eager paths and an exported graph call -----------

def _args_of(t) -> K3Args:
    return K3Args(tuple(t[0:3]), tuple(t[3:6]), tuple(t[6:9]), tuple(t[9:12]))


def _plain_op(x, *tensors):
    return fused_conv_block_plain(x, _args_of(tensors))


def _cuda_op(x, *tensors):
    return fused_conv_block_cuda(x, _args_of(tensors))


def _fake_op(x, *tensors):
    return torch.empty_like(x)


# K3 as a registered operator on x and a block's K3Args (the three folds'
# scales and offsets, the OIHW weights and the kernel's packed weights): the
# plain version on the CPU (from ``w``), the kernel on the card (from
# ``wk``), shapes only under fake tensors. Its autograd formula is
# fused_conv_block_bwd (no gradient reaches ``wk``: theirs reaches ``w``).
fused_conv_block_op = register_op(
    "fused_conv_block(Tensor x, Tensor inv1, Tensor inv2, Tensor inv3, Tensor off1, "
    "Tensor off2, Tensor off3, Tensor w1, Tensor w2, Tensor w3, Tensor wk1, Tensor wk2, "
    "Tensor wk3) -> Tensor", _plain_op, _cuda_op, _fake_op)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:10])
    ctx.wk = inputs[10:]


def _backward(ctx, grad):
    x, *t = ctx.saved_tensors
    args = K3Args(tuple(t[0:3]), tuple(t[3:6]), tuple(t[6:9]), tuple(ctx.wk))
    grads = fused_conv_block_bwd(grad.contiguous(), x, args, tuple(ctx.needs_input_grad[:10]))
    return grads + (None, None, None)


register_autograd(fused_conv_block_op, _backward, setup_context=_setup)


def fused_conv_block(x: torch.Tensor, args: K3Args) -> torch.Tensor:
    """The block through the operator: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_conv_block runs on cuda or cpu, not {x.device}")
    if x.is_cuda:
        x = x.contiguous()
    return fused_conv_block_op(x, *args.inv, *args.off, *args.w, *args.wk)


fused_conv_block.args_built = 0


def fused_conv_block_256(x, i1, f1, w1, i2, f2, w2, i3, f3, w3) -> torch.Tensor:
    """The block on the JAX package's operands: each stage's fold (inv,
    off) and its OIHW weight, x NCHW."""
    return fused_conv_block(x, make_k3_args((i1, i2, i3), (f1, f2, f3), (w1, w2, w3), x.dtype))


def conv_block_fused(p, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``models/face/fan.py::conv_block`` on a channels-equal
    256-channel ConvBlock ``p``."""
    return fused_conv_block(x, block_args(p, x.dtype))


# --- a program's folds and packed weights --------------------------------------

_program_args: contextvars.ContextVar = contextvars.ContextVar("k3_program_args",
                                                               default=None)


@contextlib.contextmanager
def program_args(args: Dict[object, K3Args]):
    """Within the block, ``models/face/fan.py::conv_block`` takes each
    ConvBlock in ``args`` through the operator with the K3Args given, on
    every device: a program (``pipeline/reenactment.py::
    make_reenact_program``) carries its blocks' folds and packed weights
    among its weights, made once, so that neither an exported graph nor a
    call repacks them."""
    token = _program_args.set(args)
    try:
        yield
    finally:
        _program_args.reset(token)


def args_in_program(p) -> Optional[K3Args]:
    """ConvBlock ``p``'s K3Args in the current program, or None."""
    args = _program_args.get()
    return None if args is None else args.get(p)
