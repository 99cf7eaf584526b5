"""K1: the hand-written CUDA kernel for upfirdn2d with (up, down) in
{(1, 1), (2, 1), (1, 2)}, and the autograd Function that runs it both ways.

Replaces the Pallas TPU kernel ``stylegan_directions_face_reenactment_tpu/
ops/pallas_upfirdn.py::_forward`` (entered there through
``upfirdn2d_pallas``, ``blur_pallas`` and ``upsample2d_pallas``) and that
file's ``_backward``, the gradient identity that the JAX package runs as an
XLA upfirdn2d (no Pallas call of its own): the cotangent through the flipped
taps with up and down swapped and the pads of :func:`grad_pad`. On the
serving path the forward runs 12 times a request: the blur after each of the
six upsampling StyledConvs and each of the six ToRGB skip upsamples. A PTI
step of source set-up adds the backward of the blurs and skip upsamples that
lie downstream of the tuned ``convs[4..11]`` (``ops/main_path.py``): the
blur's backward is up 1, down 1, pad (2, 2); the skip upsample's is up 1,
down 2, pad (1, 1).

Bound on an H100: device-memory bytes (one read of the input, one write of
the output); at most 16 FMAs an output are nothing beside them. The source
(``csrc/upfirdn2d.cu``) says what its design does about that. At batch 1
(a PTI step) a call's bytes take microseconds, so the host's share counts:
each (taps, up, down, pad, input shape, dtype, device) gets a
:class:`K1Plan` once (:func:`make_plan`, cached by :func:`plan_for`), and a
call then checks contiguity, allocates its output and makes one C call with
four arguments. :func:`launch_shape` sizes the launch (the CPU tests replay
the kernel's thread mapping on it).

* :func:`upfirdn2d_plain` is the plain PyTorch version of the same function
  (``ops/upfirdn2d.py::upfirdn2d``), and :func:`upfirdn2d_backward` the
  plain version of the backward.
* ``sdfr::upfirdn2d`` and ``sdfr::upfirdn2d_bwd`` (``upfirdn2d_op``,
  ``upfirdn2d_bwd_op``) are the registered operators that
  :func:`upfirdn2d_fir`, the eager paths and an exported graph call: the
  taps travel as a list of floats and their shape (:func:`taps_of`), each
  operator runs its plain version on a CPU tensor and its kernel on a
  CUDA tensor, and gives shapes alone under fake tensors.
* :func:`upfirdn2d_cuda` launches the forward and counts its launches in
  ``upfirdn2d_cuda.launches``; :func:`upfirdn2d_bwd_cuda` launches the
  backward and counts in ``upfirdn2d_bwd_cuda.launches``, of which
  ``upfirdn2d_bwd_cuda.down2_launches`` ran with down = 2.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .kernel_build import check, load_library, on_card_of, register_autograd, register_op
from .upfirdn2d import normalize_pad, upfirdn2d as upfirdn2d_plain, upfirdn2d_output_shape

MAX_TAPS = 4
_UPDOWN = ((1, 1), (2, 1), (1, 2))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132                    # streaming multiprocessors of an H100 SXM
OUTPUTS_PER_THREAD = 4       # adjacent outputs of a row


class _K1Params(ctypes.Structure):
    """The C struct ``K1Params`` of ``csrc/upfirdn2d.cu``."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "dtype", "up", "down", "planes", "in_h", "in_w", "out_h", "out_w", "pad_x0",
        "pad_y0", "bx", "by", "bz", "gx", "gy", "gz", "rows_in", "cols_in",
        "smem_bytes")] + [("taps", ctypes.c_float * (MAX_TAPS * MAX_TAPS))]


class K1Plan(NamedTuple):
    """Everything a K1 launch needs, made once per (taps, up, down, pad,
    input shape, dtype, device): the output shape, the C arguments (``params``,
    passed by pointer) and the pads it was made with (for a backward, the
    gradient pads)."""
    out_shape: Tuple[int, int, int, int]
    params: _K1Params
    pad: Tuple[int, int, int, int]
    device_index: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def launch_shape(planes: int, out_h: int, out_w: int, up: int, down: int):
    """The block (threads along x, rows, planes), the grid and the shared
    input band (rows, columns of one plane) of a launch. Each thread makes
    ``OUTPUTS_PER_THREAD`` adjacent outputs of a row. Blocks of 256 threads
    shrink, down to 32, while the grid has fewer blocks than the card has
    SMs."""
    per_row = -(-out_w // OUTPUTS_PER_THREAD)
    work = planes * out_h * per_row
    nt = 256
    while nt > 32 and -(-work // nt) < SMS:
        nt //= 2
    bx = min(32, _pow2_at_least(per_row), nt)
    by = min(nt // bx, _pow2_at_least(out_h))
    bz = min(nt // (bx * by), _pow2_at_least(planes))
    grid = (-(-per_row // bx), -(-out_h // by), -(-planes // bz))
    if up == 1:
        rows_in = (by - 1) * down + MAX_TAPS
        cols_in = (OUTPUTS_PER_THREAD * bx - 1) * down + MAX_TAPS
    else:
        rows_in = by // 2 + 3
        cols_in = 2 * bx + 2
    cols_in = -(-cols_in // 4) * 4          # float4 rows
    return (bx, by, bz), grid, (rows_in, cols_in)


Taps = Tuple[Tuple[float, ...], Tuple[int, int]]   # (row-major values, (kh, kw))
_taps_seen: Dict[int, tuple] = {}


def taps_of(kernel) -> Taps:
    """The taps of ``kernel`` (a tensor, an array, nested sequences or
    already a :data:`Taps` pair) as the operators take them: their values
    row-major as floats and their (kh, kw). A tensor's are read once and
    kept while it is unchanged (its id and version), so a call does not
    convert the generator's constant taps again. A fake tensor (under
    ``torch.export``) has no values to read: taps are constants, made
    outside the traced program."""
    if isinstance(kernel, tuple) and len(kernel) == 2 and isinstance(kernel[1], tuple):
        return kernel
    is_tensor = isinstance(kernel, torch.Tensor)
    if is_tensor:
        version = 0 if kernel.is_inference() else kernel._version
        hit = _taps_seen.get(id(kernel))
        if hit is not None and hit[0] is kernel and hit[1] == version:
            return hit[2]
    k = np.asarray(kernel.detach().cpu() if is_tensor else kernel, np.float32)
    if k.ndim != 2 or k.shape[0] > MAX_TAPS or k.shape[1] > MAX_TAPS:
        raise ValueError(f"upfirdn2d kernel takes at most {MAX_TAPS}x{MAX_TAPS} "
                         f"taps, got {k.shape}")
    taps = (tuple(float(v) for v in k.ravel()), (int(k.shape[0]), int(k.shape[1])))
    if is_tensor:
        if len(_taps_seen) >= 256:
            _taps_seen.clear()
        _taps_seen[id(kernel)] = (kernel, version, taps)
    return taps


def _taps(kernel) -> np.ndarray:
    values, shape = taps_of(kernel)
    return np.asarray(values, np.float32).reshape(shape)


def make_plan(in_shape, dtype: torch.dtype, device: torch.device, kernel, up: int,
              down: int, pad, what: str = "upfirdn2d_cuda") -> K1Plan:
    """The launch plan of ``upfirdn2d(x, taps, up, down, pad)`` for an NCHW
    input of ``in_shape``; ``kernel`` holds the taps as the plain version
    takes them (not flipped). Raises on what the kernel does not take."""
    if device.type != "cuda":
        raise ValueError(f"{what} takes a CUDA tensor")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} takes float32 or bfloat16, got {dtype}")
    if len(in_shape) != 4:
        raise ValueError(f"{what} takes a contiguous NCHW tensor")
    if (up, down) not in _UPDOWN:
        raise ValueError(f"{what} takes (up, down) in {_UPDOWN}, got {(up, down)}")
    k = _taps(kernel)
    kh, kw = k.shape
    px0, px1, py0, py1 = normalize_pad(pad)
    n, c, h, w = (int(d) for d in in_shape)
    out_h, out_w = upfirdn2d_output_shape(h, w, (kh, kw), up=up, down=down, pad=pad)
    if out_h < 1 or out_w < 1:
        raise ValueError(f"{what}: empty output {out_h}x{out_w}")
    (bx, by, bz), (gx, gy, gz), (rows_in, cols_in) = launch_shape(n * c, out_h, out_w,
                                                                  up, down)
    taps = np.zeros((MAX_TAPS, MAX_TAPS), np.float32)
    taps[:kh, :kw] = k[::-1, ::-1]
    params = _K1Params(_DTYPE_CODE[dtype], up, down, n * c, h, w, out_h, out_w, px0, py0,
                       bx, by, bz, gx, gy, gz, rows_in, cols_in,
                       4 * bz * rows_in * cols_in,
                       (ctypes.c_float * taps.size)(*taps.ravel().tolist()))
    return K1Plan((n, c, out_h, out_w), params, (px0, px1, py0, py1),
                  device.index if device.index is not None else torch.cuda.current_device())


_plans: Dict[tuple, K1Plan] = {}


def plan_for(x: torch.Tensor, kernel, up: int, down: int, pad, what: str) -> K1Plan:
    """The cached plan for input ``x`` (made on its first call); plans are
    keyed by the taps' values, so equal taps share one."""
    key = (taps_of(kernel), up, down, tuple(pad), x.shape, x.dtype, x.device)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = make_plan(tuple(x.shape), x.dtype, x.device, kernel, up, down,
                                       pad, what)
    return plan


def grad_pad(kernel_shape: Tuple[int, int], up: int, pad,
             in_hw: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """The pads (px0, px1, py0, py1) of the gradient of an up-``up``, down-1
    upfirdn2d with ``pad`` over an input of ``in_hw``: per axis
    ``(k - p0 - 1, in·up - out + p0 - up + 1)`` (the reference's
    ``op/upfirdn2d.py:104-117``, as the JAX package's ``_backward``),
    computed per axis since ``pad`` may differ between them."""
    kh, kw = kernel_shape
    px0, px1, py0, py1 = normalize_pad(pad)
    h, w = in_hw
    oh, ow = upfirdn2d_output_shape(h, w, (kh, kw), up=up, pad=pad)
    return (kw - px0 - 1, w * up - ow + px0 - up + 1,
            kh - py0 - 1, h * up - oh + py0 - up + 1)


def upfirdn2d_backward(grad: torch.Tensor, kernel, up: int, pad,
                       in_shape: Sequence[int]) -> torch.Tensor:
    """Plain version of the backward: the gradient with respect to the input
    (of NCHW shape ``in_shape``) of ``upfirdn2d(x, kernel, up, down=1, pad)``
    from the output's gradient ``grad``: an upfirdn2d of ``grad`` with the
    flipped taps, up 1, down ``up``, and the pads of :func:`grad_pad`."""
    k = torch.as_tensor(kernel, dtype=torch.float32)
    gpad = grad_pad(tuple(k.shape), up, pad, tuple(in_shape[2:]))
    return upfirdn2d_plain(grad, torch.flip(k, (0, 1)), up=1, down=up, pad=gpad)


def _run(x: torch.Tensor, plan: K1Plan, what: str) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous NCHW tensor")
    y = torch.empty(plan.out_shape, dtype=x.dtype, device=x.device)
    with on_card_of(x):
        check(load_library().upfirdn2d_run(ctypes.byref(plan.params), x.data_ptr(),
                                           y.data_ptr(),
                                           torch._C._cuda_getCurrentRawStream(plan.device_index)),
              what)
    return y


def _launch(x: torch.Tensor, taps: Taps, up: int, pad) -> torch.Tensor:
    y = _run(x, plan_for(x, taps, up, 1, pad, "upfirdn2d_cuda"), "upfirdn2d_cuda")
    upfirdn2d_cuda.launches += 1
    return y


def upfirdn2d_cuda(x: torch.Tensor, kernel, up: int,
                   pad: Tuple[int, ...]) -> torch.Tensor:
    """Launch K1 (down 1) on a contiguous NCHW CUDA tensor (f32 or bf16)."""
    return _launch(x, taps_of(kernel), up, pad)


upfirdn2d_cuda.launches = 0


def _bwd_plan(grad: torch.Tensor, kernel, up: int, pad, in_shape) -> K1Plan:
    taps = taps_of(kernel)
    key = ("bwd", taps, up, tuple(pad), grad.shape, tuple(in_shape), grad.dtype,
           grad.device)
    plan = _plans.get(key)
    if plan is None:
        k = _taps(taps)
        gpad = grad_pad(k.shape, up, pad, tuple(in_shape[2:]))
        plan = make_plan(tuple(grad.shape), grad.dtype, grad.device,
                         np.ascontiguousarray(k[::-1, ::-1]), 1, up, gpad,
                         "upfirdn2d_bwd_cuda")
        if plan.out_shape != tuple(in_shape):
            raise ValueError(f"upfirdn2d_bwd_cuda: gradient of shape {plan.out_shape} "
                             f"for an input of {tuple(in_shape)}")
        _plans[key] = plan
    return plan


def _launch_bwd(grad: torch.Tensor, taps: Taps, up: int, pad, in_shape) -> torch.Tensor:
    dx = _run(grad, _bwd_plan(grad, taps, up, pad, in_shape), "upfirdn2d_bwd_cuda")
    upfirdn2d_bwd_cuda.launches += 1
    upfirdn2d_bwd_cuda.down2_launches += int(up == 2)
    return dx


def upfirdn2d_bwd_cuda(grad: torch.Tensor, kernel, up: int, pad,
                       in_shape: Sequence[int]) -> torch.Tensor:
    """Launch K1 on the backward of ``upfirdn2d_cuda(x, kernel, up, pad)``:
    the gradient with respect to x (NCHW ``in_shape``) from ``grad``, a
    contiguous CUDA tensor (f32 or bf16). :func:`upfirdn2d_backward` is its
    plain version."""
    return _launch_bwd(grad, taps_of(kernel), up, pad, in_shape)


upfirdn2d_bwd_cuda.launches = 0
upfirdn2d_bwd_cuda.down2_launches = 0


# --- the operators: what the eager paths and an exported graph call ----------

def _taps_tensor(taps: List[float], shape: List[int]) -> torch.Tensor:
    return torch.tensor(taps, dtype=torch.float32).reshape(shape)


def _plain_op(x, taps, taps_shape, up, pad):
    return upfirdn2d_plain(x, _taps_tensor(taps, taps_shape), up=up, down=1, pad=tuple(pad))


def _cuda_op(x, taps, taps_shape, up, pad):
    return _launch(x, (tuple(taps), tuple(taps_shape)), up, tuple(pad))


def _fake_op(x, taps, taps_shape, up, pad):
    n, c, h, w = x.shape
    oh, ow = upfirdn2d_output_shape(h, w, tuple(taps_shape), up=up, pad=tuple(pad))
    return x.new_empty((n, c, oh, ow))


def _plain_bwd_op(grad, taps, taps_shape, up, pad, in_shape):
    # down 2 keeps every other sample: a strided view, made contiguous
    return upfirdn2d_backward(grad, _taps_tensor(taps, taps_shape), up, tuple(pad),
                              in_shape).contiguous()


def _cuda_bwd_op(grad, taps, taps_shape, up, pad, in_shape):
    return _launch_bwd(grad, (tuple(taps), tuple(taps_shape)), up, tuple(pad), in_shape)


def _fake_bwd_op(grad, taps, taps_shape, up, pad, in_shape):
    return grad.new_empty(in_shape)


# K1 (down 1) as a registered operator: the plain version on the CPU, the
# kernel on the card, shapes only under fake tensors. ``taps`` are the
# (kh, kw) = ``taps_shape`` taps row-major, not flipped; ``pad`` (p0, p1) or
# (px0, px1, py0, py1). Its autograd formula is upfirdn2d_bwd.
upfirdn2d_op = register_op(
    "upfirdn2d(Tensor x, float[] taps, int[] taps_shape, int up, int[] pad) -> Tensor",
    _plain_op, _cuda_op, _fake_op)
# K1-bwd: the gradient with respect to the input (NCHW ``in_shape``) of
# upfirdn2d(x, taps, up, pad): K1 with the flipped taps at down ``up``
upfirdn2d_bwd_op = register_op(
    "upfirdn2d_bwd(Tensor grad, float[] taps, int[] taps_shape, int up, int[] pad, "
    "int[] in_shape) -> Tensor", _plain_bwd_op, _cuda_bwd_op, _fake_bwd_op)


def _setup(ctx, inputs, output):
    x, ctx.taps, ctx.taps_shape, ctx.up, ctx.pad = inputs
    ctx.in_shape = list(x.shape)


def _backward(ctx, grad):
    """K1-bwd; only the input gets a gradient: the taps are constants."""
    dx = upfirdn2d_bwd_op(grad.contiguous(), ctx.taps, ctx.taps_shape, ctx.up, ctx.pad,
                          ctx.in_shape)
    return dx, None, None, None, None


register_autograd(upfirdn2d_op, _backward, setup_context=_setup)


def upfirdn2d_fir(x: torch.Tensor, kernel, up: int,
                  pad: Tuple[int, ...]) -> torch.Tensor:
    """upfirdn2d with up in {1, 2}, down 1, through the operator: the kernel
    for a CUDA tensor (made contiguous), the plain version for a CPU tensor."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"upfirdn2d runs on cuda or cpu, not {x.device}")
    if x.is_cuda:
        x = x.contiguous()
    values, shape = taps_of(kernel)
    return upfirdn2d_op(x, list(values), list(shape), int(up), [int(p) for p in pad])
