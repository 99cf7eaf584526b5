#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths once on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA card and the CUDA
toolkit. It imports the port (``stylegan_directions_face_reenactment_tpu_torch``)
and nothing of JAX or the JAX package. Phases, in order; any failure exits
non-zero without printing the last line:

1. device: the card's name, count, power limit;
2. build: K1 (upfirdn2d), K2 (fused bias-act) and K3 (the FAN ConvBlock)
   from ``csrc/`` with nvcc, with each kernel's registers and shared memory;
3. kernel parity: each kernel against its plain PyTorch version on the card
   at every shape the serving paths give it (a batch of 16), float32 and
   bf16, TF32 off; K3 also at the batch-1 shapes of the source's DECA and at
   ragged sizes, and run twice to show its split-K sums are bit-equal;
4. kernel timing, three numbers a call at those shapes: the device time
   (CUDA events around the replay of a CUDA graph that captured the calls,
   so no host work sits between launches), the host µs a call (host clock
   around un-synchronized calls) and the call time (CUDA events around
   back-to-back calls, the pace of whichever of the two is slower); beside
   the plain version, one PyTorch library call computing the same function
   where there is one (the same three numbers), and the least time the card
   could take, summed over one request; K3's per-size rows beside the cuDNN
   composition and its device time by kernel (prologue, stage GEMMs,
   split-K passes) from torch.profiler;
5. slice 1, the resize path: random-init voxceleb-256 generator (channel
   multiplier 1, 8 mapping layers), A (15 → 8·512) and DECA ResNet-50 at
   224, served through ``make_reenact_fn`` for requests of 16, 16 and 5
   frames in float32 and bf16; launch counts per request, output checks,
   frames 0-1 of the first request against the same weights on the CPU
   (bf16 stage by stage), the median frames/s over rounds of the three
   requests repeated for at least ``WINDOW_S`` seconds with its spread,
   peak memory, a breakdown;
6. slice 2, the default path: the same nets plus S3FD and 2DFAN4 (4
   modules), served through ``make_fused_reenact_fn`` on uint8 raw frames
   of 562×1000 (the CLI's width-1000 detection shape) for requests of 16,
   16 and 5 frames in float32 and bf16, with K1/K2/K3 launch counts of
   12/13/112 a request; frames 0-1 of the first request checked stage by
   stage against the CPU (float32, and bf16 against the CPU's bf16 on the
   same inputs); one request each through the reuse-landmarks
   paths; a breakdown by stage and by kernel class;
7. slice 3, source set-up: the same nets plus a seeded e4e (IR-SE50 at 256,
   14 styles) and LPIPS/AlexNet, all float32; one 256² source face made by
   the generator goes through ``setup_source`` (e4e inversion, 200 PTI
   steps of 100·MSE + LPIPS over ``convs[4..11]``, the source's SFD → FAN
   DECA coefficients), with the launches a PTI step of K1 and K2 forward
   and of their backwards (K1 with down = 2 for the skip upsamples), the
   loss history, the caller's generator untouched and only ``convs[4..11]``
   tuned; the e4e code, the first PTI step's loss and gradients and the
   losses of 3 steps against the CPU; e4e, PTI-step, source-DECA and
   set-up times and peak memory; one request of 16 raw frames served from
   the tuned generator. The backward kernels join phases 3 and 4 at the
   shapes of one PTI step (``ops/main_path.py::pti_backward_calls``).

The last two lines are the kernels' numbers and ``{"ok": true, ...}``.
"""

import copy
import json
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

PORT = "stylegan_directions_face_reenactment_tpu_torch"
try:
    from stylegan_directions_face_reenactment_tpu_torch.configs import MODELS
except ImportError as e:
    sys.exit(f"chip_smoke: FAILED: {PORT} is not importable ({e}); run this "
             "script from the repository root")

SIZE = MODELS["voxceleb"]["resolution"]
CM = MODELS["voxceleb"]["channel_multiplier"]
BATCH = 16
REQUESTS = (16, 16, 5)
K1_PER_REQUEST, K2_PER_REQUEST = 12, 13
K3_PER_REQUEST, K3_PER_PASS = 112, 56   # two FAN passes of 4 modules x 14 blocks
F32_TOL, BF16_TOL = 1e-5, 1e-2
K3_F32_TOL = 1e-5                       # relative to max(1, max|plain|): 2304-term sums
REPS = 50
WINDOW_S, MIN_ROUNDS = 3.0, 10       # slice 1's timed window, per dtype
FRAME_HW = (562, 1000)               # a 16:9 frame at the CLI's detection width
WINDOW2_S, MIN_ROUNDS2 = 5.0, 3      # slice 2's timed window, per dtype
K3_FLOP_PER_PIXEL = 2 * 9 * (256 * 128 + 128 * 64 + 64 * 64)
# bf16, frames 0-1 of request 1, mean relative drift on an H100. Between
# processes with the same seeds the card's bf16 image read 0.024-0.057 from
# its float32 image, and 0.014-0.082 from the CPU's bf16 image: the
# random-init DECA -> dp -> A chain turns a last-digit difference in a
# coefficient into another shift. So the card is held against the CPU's bf16
# stage by stage, where nothing amplifies: DECA's coefficients from the same
# frames (read 0.0040-0.0043) and the synthesis from the same latents
# (0.0058-0.0059). Limits about twice the largest reading.
BF16_DRIFT, BF16_DECA, BF16_SYNTH = 0.1, 0.009, 0.012
# slice 2's bf16 stages, card vs CPU bf16 on the same inputs (bf16_stages),
# read on an H100: SFD's worst head 0.0114, FAN heatmaps 0.0123 (max |diff|
# 0.0179 of max|heatmap|), DECA coefficients 0.0039. Limits about twice.
BF16_SFD, BF16_FAN, BF16_FAN_MAX, BF16_DECA2 = 0.025, 0.025, 0.04, 0.009
PTI_STEPS, PTI_LR = 200, 3e-3           # setup_source's defaults, the CLI's
PTI_RUNS, PTI_RUN_STEPS = 5, 20         # the timed PTI runs
CPU_PTI_STEPS = 3                       # the PTI steps held against the CPU
# each IR-SE block's last batch-norm scale in the seeded e4e: at the random
# init the 24 residual blocks grow the activations some 30,000-fold and turn
# last-digit differences into percent differences of the code
# (tests/test_torch_e4e.py); a trained encoder's branches are damped too
E4E_BN2_SCALE = 0.3


class SmokeFailure(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_rates(name):
    """(memory bytes/s, float32 FLOP/s outside the tensor cores, dense bf16
    tensor-core FLOP/s) of the card, from the published data sheets (SXM
    part unless the name says PCIe/NVL)."""
    if "H200" in name:
        return 4.8e12, 67e12, 989e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12, 756e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 60e12, 835e12
    return 3.35e12, 67e12, 989e12


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    need(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps=REPS):
    """Call time, mean ms a call: CUDA events around ``reps`` back-to-back
    calls after a warm-up. Where a call's host work exceeds its device work
    this is the host's pace, not the kernel's: see :func:`device_ms` and
    :func:`host_us`."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=REPS):
    """Device time, mean ms a call: CUDA events around the replay of a CUDA
    graph that captured ``reps`` calls, so no host work sits between the
    launches (the gaps between a graph's kernels, about a microsecond, are
    in it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def host_us(fn, reps=REPS):
    """Host µs a call: the host clock around ``reps`` calls with no
    synchronize, once the stream is warm."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def three_times(fn):
    """(device ms, host µs, call ms) of one call."""
    return device_ms(fn), host_us(fn), time_ms(fn)


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def limit_for(want):
    """float32: F32_TOL absolute (the sums run in another order); bf16:
    BF16_TOL relative to max(1, max|plain|) (one bf16 rounding either way)."""
    if want.dtype == torch.float32:
        return F32_TOL
    return BF16_TOL * max(1.0, float(want.float().abs().max()))


def mean_rel(got, want):
    """mean |got - want| / mean |want|."""
    return float((got.double() - want.double()).abs().mean() / want.double().abs().mean())


def allclose_scaled(got, want, rtol, atol_rel):
    """|got - want| <= atol_rel·max|want| + rtol·|want| everywhere."""
    atol = atol_rel * float(want.abs().max())
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def phase_device():
    need(torch.cuda.is_available(), "no CUDA device is available")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] {name}; count {torch.cuda.device_count()}; nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from stylegan_directions_face_reenactment_tpu_torch.ops import kernel_build
    info = kernel_build.build()
    kernel_build.load_library()
    print(f"[build] {info['path']} in {info['seconds']:.2f} s (nvcc, sm_90a)")
    for line in kernel_build.ptxas_summary(info["ptxas"]):
        print(f"[build] {line}")


def k1_inputs(dtype, gen):
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import upfirdn2d_calls
    return [(c, torch.randn(c.shape, generator=gen, device="cuda").to(dtype))
            for c in upfirdn2d_calls(SIZE, CM, BATCH)]


def k2_inputs(dtype, gen, with_mapping=False):
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import fused_bias_act_calls
    shapes = fused_bias_act_calls(SIZE, CM, BATCH)
    if with_mapping:
        shapes = shapes + [(BATCH, 512), (4096, 512)]
    out = []
    for s in shapes:
        x = torch.randn(s, generator=gen, device="cuda").to(dtype)
        out.append((s, x, torch.randn(s[1], generator=gen, device="cuda")))
    return out


def k3_inputs(dtype, gen, batch=BATCH):
    """(shape, calls of that shape in one FAN pass, x, K3Args) for each K3
    shape of a FAN pass over ``batch`` crops (16 on the serving path, 1 for
    the source's DECA): folds near 1 and 0, He-scaled weights."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_conv_block import (
        make_k3_args)
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
        fused_conv_block_calls)
    out = []
    for shape, n in sorted(Counter(fused_conv_block_calls(batch)).items(),
                           key=lambda kv: -kv[0][2]):
        cs = ((256, 128), (128, 64), (64, 64))
        inv = [1 + 0.1 * torch.randn(ci, generator=gen, device="cuda") for ci, _ in cs]
        off = [0.1 * torch.randn(ci, generator=gen, device="cuda") for ci, _ in cs]
        w = [torch.randn(co, ci, 3, 3, generator=gen, device="cuda") * (2.0 / (9 * co)) ** 0.5
             for ci, co in cs]
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        out.append((shape, n, x, make_k3_args(inv, off, w, dtype)))
    return out


def library_k1(x, k, call):
    """One cuDNN depthwise call computing the same function, as a
    closure over ``x`` and a depthwise weight built here, once, so that a
    timed call is the convolution alone."""
    c = x.shape[1]
    if call.up == 1:
        w = k.flip(0, 1).to(x)[None, None].expand(c, 1, -1, -1).contiguous()
        return lambda: F.conv2d(x, w, padding=call.pad[0], groups=c)
    w = k.to(x)[None, None].expand(c, 1, -1, -1).contiguous()
    return lambda: F.conv_transpose2d(x, w, stride=2, padding=1, groups=c)


def phase_parity():
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
        fused_bias_act_cuda, fused_leaky_relu_plain)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import (
        make_kernel, upfirdn2d)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
        upfirdn2d_cuda)
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_conv_block import (
        fused_conv_block_cuda, fused_conv_block_plain, schedule as fcb_schedule)
    k = make_kernel((1, 3, 3, 1), gain=4)
    worst = {"upfirdn2d": 0.0, "fused_bias_act": 0.0, "fused_conv_block": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for call, x in k1_inputs(dtype, gen):
            got = upfirdn2d_cuda(x, k, call.up, call.pad)
            want = upfirdn2d(x, k, up=call.up, pad=call.pad)
            lib = library_k1(x, k, call)()
            torch.cuda.synchronize()
            err, lim = max_err(got, want), limit_for(want)
            print(f"[parity] upfirdn2d {call.name} {tuple(x.shape)} {str(dtype)[6:]}: "
                  f"max abs err {err:.3g} (limit {lim:.3g}); library call err "
                  f"{max_err(lib, want):.3g}")
            need(got.shape == want.shape and err <= lim,
                 f"upfirdn2d {call.name} {dtype} disagrees with its plain version")
            if dtype == torch.float32:   # bf16 library calls round elsewhere
                need(max_err(lib, want) <= lim, f"library call for {call.name} is "
                     "not the same function")
            if dtype == torch.float32:
                worst["upfirdn2d"] = max(worst["upfirdn2d"], err)
        for shape, x, b in k2_inputs(dtype, gen, with_mapping=True):
            got = fused_bias_act_cuda(x, b)
            want = fused_leaky_relu_plain(x, b)
            torch.cuda.synchronize()
            err, lim = max_err(got, want), limit_for(want)
            print(f"[parity] fused_bias_act {shape} {str(dtype)[6:]}: max abs err "
                  f"{err:.3g} (limit {lim:.3g})")
            need(err <= lim, f"fused_bias_act {shape} {dtype} disagrees")
            if dtype == torch.float32:
                worst["fused_bias_act"] = max(worst["fused_bias_act"], err)
        k3_cases = [c for b in (BATCH, 1) for c in k3_inputs(dtype, gen, b)]
        for shape in ((2, 256, 5, 7), (3, 256, 9, 33), (3, 256, 1, 1)):   # ragged tiles
            k3_cases.append((shape, 0, torch.randn(shape, generator=gen, device="cuda").to(dtype),
                             k3_cases[0][3]))
        for shape, _, x, args in k3_cases:
            got = fused_conv_block_cuda(x, args)
            want = fused_conv_block_plain(x, args)
            again = fused_conv_block_cuda(x, args)
            torch.cuda.synchronize()
            err, scale = max_err(got, want), max(1.0, float(want.float().abs().max()))
            lim = K3_F32_TOL * scale if dtype == torch.float32 else BF16_TOL * scale
            same = torch.equal(got, again)
            print(f"[parity] fused_conv_block {shape} {str(dtype)[6:]} (splits "
                  f"{fcb_schedule(shape[0], shape[2], shape[3], dtype).splits}): max abs err "
                  f"{err:.3g} (limit {lim:.3g}; max|plain| {scale:.3g}); a second run "
                  f"bit-equal: {same}")
            need(got.shape == want.shape and err <= lim,
                 f"fused_conv_block {shape} {dtype} disagrees with its plain version")
            need(same, f"fused_conv_block {shape} {dtype}: two runs differ")
            if dtype == torch.float32:
                worst["fused_conv_block"] = max(worst["fused_conv_block"], err)
    return worst


def phase_timing(card_name):
    """Per-request sums over the serving path's shapes (TF32 off)."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
        fused_bias_act_cuda, fused_leaky_relu_plain)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import (
        make_kernel, upfirdn2d, upfirdn2d_output_shape)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
        upfirdn2d_cuda)
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_conv_block import (
        fused_conv_block_cuda, fused_conv_block_plain)
    bw, flops, bf16_flops = card_rates(card_name)
    k = make_kernel((1, 3, 3, 1), gain=4)
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        t = {}
        for call, x in k1_inputs(dtype, gen):
            oh, ow = upfirdn2d_output_shape(x.shape[2], x.shape[3], (4, 4), up=call.up,
                                            pad=call.pad)
            n_out = x.shape[0] * x.shape[1] * oh * ow
            nbytes = (x.numel() + n_out) * x.element_size()
            ops = n_out * 2 * 16 // (call.up * call.up)   # taps that meet a sample
            bound = 1e3 * max(nbytes / bw, ops / flops)
            ms, host, call_ms = three_times(lambda: upfirdn2d_cuda(x, k, call.up, call.pad))
            plain = time_ms(lambda: upfirdn2d(x, k, up=call.up, pad=call.pad))
            lib, lib_host, lib_call = three_times(library_k1(x, k, call))
            print(f"[timing] upfirdn2d {call.name} {tuple(x.shape)} {tag}: kernel device "
                  f"{ms:.4f} ms, host {host:.2f} us, call {call_ms:.4f} ms; plain {plain:.4f} "
                  f"ms; library device {lib:.4f} ms, host {lib_host:.2f} us, call "
                  f"{lib_call:.4f} ms; bound {bound:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s)")
            add(t, ms=ms, host_us=host, call_ms=call_ms, plain_ms=plain, library_ms=lib,
                library_host_us=lib_host, library_call_ms=lib_call, bound_ms=bound,
                bytes=nbytes, ops=ops)
        out[("upfirdn2d", tag)] = t
        t = {"library_ms": None}
        for shape, x, b in k2_inputs(dtype, gen):
            nbytes = 2 * x.numel() * x.element_size() + b.numel() * x.element_size()
            ops = 3 * x.numel()
            bound = 1e3 * max(nbytes / bw, ops / flops)
            ms, host, call_ms = three_times(lambda: fused_bias_act_cuda(x, b))
            plain = time_ms(lambda: fused_leaky_relu_plain(x, b))
            print(f"[timing] fused_bias_act {shape} {tag}: kernel device {ms:.4f} ms, host "
                  f"{host:.2f} us, call {call_ms:.4f} ms; plain {plain:.4f} ms; bound "
                  f"{bound:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s)")
            add(t, ms=ms, host_us=host, call_ms=call_ms, plain_ms=plain, bound_ms=bound,
                bytes=nbytes, ops=ops)
        out[("fused_bias_act", tag)] = t
        # K3: every call of the two FAN passes of a request
        rate = flops if dtype == torch.float32 else bf16_flops
        # the plain version on the card is the cuDNN composition (three
        # convolutions and the elementwise folds): its device time is the
        # per-size yardstick, though no single PyTorch call computes K3
        t = {"library_ms": None}
        for shape, n, x, args in k3_inputs(dtype, gen):
            calls = 2 * n
            weights = sum(w.numel() for w in args.wk) + 2 * (256 + 128 + 64)
            nbytes = (2 * x.numel() + weights) * x.element_size()
            ops = K3_FLOP_PER_PIXEL * shape[0] * shape[2] * shape[3]
            bound = 1e3 * max(nbytes / bw, ops / rate)
            ms, host, call_ms = three_times(lambda: fused_conv_block_cuda(x, args))
            plain, plain_host, plain_call = three_times(lambda: fused_conv_block_plain(x, args))
            print(f"[timing] fused_conv_block {shape} {tag} x{calls} a request: kernel device "
                  f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s), host {host:.2f} us, call "
                  f"{call_ms:.4f} ms; cuDNN composition device {plain:.4f} ms, host "
                  f"{plain_host:.2f} us, call {plain_call:.4f} ms; bound {bound:.4f} ms "
                  f"(operations at {rate / 1e12:.0f} TFLOP/s); kernel/composition "
                  f"{ms / plain:.3f}")
            add(t, ms=calls * ms, host_us=calls * host, call_ms=calls * call_ms,
                plain_ms=calls * plain, plain_call_ms=calls * plain_call,
                bound_ms=calls * bound, bytes=calls * nbytes, ops=calls * ops)
        out[("fused_conv_block", tag)] = t
    for (name, tag), t in out.items():
        print_sums(f"[timing] {name} per request of {BATCH} frames, {tag}", t, bw)
    return out


def k3_breakdown():
    """K3's device time a call by kernel (the prologue, the stage GEMMs, the
    split-K reduce passes) at each size of the serving path, from
    torch.profiler's device events over 5 calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_conv_block import (
        fused_conv_block_cuda)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        for shape, _, x, args in k3_inputs(dtype, gen):
            fused_conv_block_cuda(x, args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fused_conv_block_cuda(x, args)
                torch.cuda.synchronize()
            parts = {}
            for e in prof.key_averages():
                dev = getattr(e, "self_device_time_total", None)
                if dev is None:
                    dev = getattr(e, "self_cuda_time_total", 0)
                if e.device_type == DeviceType.CUDA and "fcb_" in e.key:
                    kind = e.key.split("fcb_")[1].split("<")[0].split("(")[0].split("I")[0]
                    parts[kind] = parts.get(kind, 0.0) + dev / 5
            print(f"[timing] fused_conv_block {shape} {str(dtype)[6:]} by kernel, us a call: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in sorted(parts.items())))


def add(t, **values):
    """Add each value into the sums ``t``."""
    for key, v in values.items():
        t[key] = t.get(key, 0) + v


def print_sums(label, t, bw):
    lib = ("none" if t.get("library_ms") is None else
           f"device {t['library_ms']:.4f} ms, host {t['library_host_us']:.2f} us, call "
           f"{t['library_call_ms']:.4f} ms")
    print(f"{label}: kernel device {t['ms']:.4f} ms, host {t['host_us']:.2f} us, call "
          f"{t['call_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; library {lib}; bound "
          f"{t['bound_ms']:.4f} ms ({t['bytes'] / 1e9:.4f} GB over {bw / 1e12:.2f} TB/s; "
          f"{t['ops'] / 1e12:.4f} TFLOP)")


def k1_bwd_inputs(dtype, gen):
    """(call, gradient of its output) for each K1 backward of one PTI step."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import pti_backward_calls
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import (
        upfirdn2d_output_shape)
    out = []
    for c in pti_backward_calls(SIZE, CM).upfirdn2d:
        oh, ow = upfirdn2d_output_shape(c.shape[2], c.shape[3], (4, 4), up=c.up, pad=c.pad)
        out.append((c, torch.randn(c.shape[:2] + (oh, ow), generator=gen,
                                   device="cuda").to(dtype)))
    return out


def k2_bwd_inputs(dtype, gen):
    """(shape, g, y) for each K2-bwd of one PTI step; y is an activation
    output, negative on about half its elements."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
        fused_leaky_relu_plain)
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import pti_backward_calls
    out = []
    for s in pti_backward_calls(SIZE, CM).fused_bias_act:
        g = torch.randn(s, generator=gen, device="cuda").to(dtype)
        y = fused_leaky_relu_plain(torch.randn(s, generator=gen, device="cuda").to(dtype))
        out.append((s, g, y))
    return out


def library_k1_bwd(g, k, call):
    """One cuDNN depthwise ``conv2d`` computing K1's backward of ``call``:
    the taps unflipped (the gradient flips the forward's flipped taps back),
    pad 2 for the blur, stride 2 and pad 1 for the skip upsample."""
    c = g.shape[1]
    w = k.to(g)[None, None].expand(c, 1, -1, -1).contiguous()
    stride, pad = (1, 2) if call.up == 1 else (2, 1)
    return lambda: F.conv2d(g, w, stride=stride, padding=pad, groups=c)


def phase_parity_bwd():
    """The backward kernels against their plain versions at every shape of
    one PTI step, float32 and bf16."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
        fused_bias_act_bwd_cuda, fused_leaky_relu_bwd_plain)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import make_kernel
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
        upfirdn2d_backward, upfirdn2d_bwd_cuda)
    k = make_kernel((1, 3, 3, 1), gain=4)
    worst = {"upfirdn2d_bwd": 0.0, "fused_bias_act_bwd": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        for call, g in k1_bwd_inputs(dtype, gen):
            got = upfirdn2d_bwd_cuda(g, k, call.up, call.pad, call.shape)
            want = upfirdn2d_backward(g, k, call.up, call.pad, call.shape)
            lib = library_k1_bwd(g, k, call)()
            torch.cuda.synchronize()
            err, lim = max_err(got, want), limit_for(want)
            print(f"[parity] upfirdn2d_bwd {call.name} (down {call.up}) {tuple(g.shape)} -> "
                  f"{tuple(want.shape)} {str(dtype)[6:]}: max abs err {err:.3g} (limit "
                  f"{lim:.3g}); library call err {max_err(lib, want):.3g}")
            need(tuple(got.shape) == tuple(call.shape) and err <= lim,
                 f"upfirdn2d_bwd {call.name} {dtype} disagrees with its plain version")
            if dtype == torch.float32:
                need(max_err(lib, want) <= lim, f"library call for the backward of "
                     f"{call.name} is not the same function")
                worst["upfirdn2d_bwd"] = max(worst["upfirdn2d_bwd"], err)
        for shape, g, y in k2_bwd_inputs(dtype, gen):
            got = fused_bias_act_bwd_cuda(g, y)
            want = fused_leaky_relu_bwd_plain(g, y)
            torch.cuda.synchronize()
            err, lim = max_err(got, want), limit_for(want)
            print(f"[parity] fused_bias_act_bwd {shape} {str(dtype)[6:]}: max abs err "
                  f"{err:.3g} (limit {lim:.3g})")
            need(err <= lim, f"fused_bias_act_bwd {shape} {dtype} disagrees")
            if dtype == torch.float32:
                worst["fused_bias_act_bwd"] = max(worst["fused_bias_act_bwd"], err)
    return worst


def phase_timing_bwd(card_name):
    """Per-PTI-step sums of the backward kernels over one PTI step's shapes
    (TF32 off)."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
        fused_bias_act_bwd_cuda, fused_leaky_relu_bwd_plain)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import make_kernel
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
        upfirdn2d_backward, upfirdn2d_bwd_cuda)
    bw, flops, _ = card_rates(card_name)
    k = make_kernel((1, 3, 3, 1), gain=4)
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        t = {}
        for call, g in k1_bwd_inputs(dtype, gen):
            n_out = 1
            for d in call.shape:
                n_out *= d
            nbytes = (g.numel() + n_out) * g.element_size()
            ops = n_out * 2 * 16       # up 1: every tap meets a sample
            bound = 1e3 * max(nbytes / bw, ops / flops)
            ms, host, call_ms = three_times(
                lambda: upfirdn2d_bwd_cuda(g, k, call.up, call.pad, call.shape))
            plain = time_ms(lambda: upfirdn2d_backward(g, k, call.up, call.pad, call.shape))
            lib, lib_host, lib_call = three_times(library_k1_bwd(g, k, call))
            print(f"[timing] upfirdn2d_bwd {call.name} (down {call.up}) {tuple(g.shape)} {tag}: "
                  f"kernel device {ms:.4f} ms, host {host:.2f} us, call {call_ms:.4f} ms; plain "
                  f"{plain:.4f} ms; library device {lib:.4f} ms, host {lib_host:.2f} us, call "
                  f"{lib_call:.4f} ms; bound {bound:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s)")
            add(t, ms=ms, host_us=host, call_ms=call_ms, plain_ms=plain, library_ms=lib,
                library_host_us=lib_host, library_call_ms=lib_call, bound_ms=bound,
                bytes=nbytes, ops=ops)
        out[("upfirdn2d_bwd", tag)] = t
        t = {"library_ms": None}
        for shape, g, y in k2_bwd_inputs(dtype, gen):
            nbytes = 3 * g.numel() * g.element_size()
            ops = 2 * g.numel()         # a compare and a multiply
            bound = 1e3 * max(nbytes / bw, ops / flops)
            ms, host, call_ms = three_times(lambda: fused_bias_act_bwd_cuda(g, y))
            plain = time_ms(lambda: fused_leaky_relu_bwd_plain(g, y))
            print(f"[timing] fused_bias_act_bwd {shape} {tag}: kernel device {ms:.4f} ms, "
                  f"host {host:.2f} us, call {call_ms:.4f} ms; plain {plain:.4f} ms; bound "
                  f"{bound:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s)")
            add(t, ms=ms, host_us=host, call_ms=call_ms, plain_ms=plain, bound_ms=bound,
                bytes=nbytes, ops=ops)
        out[("fused_bias_act_bwd", tag)] = t
    for (name, tag), t in out.items():
        print_sums(f"[timing] {name} per PTI step, {tag}", t, bw)
    return out


def phase_slice():
    from stylegan_directions_face_reenactment_tpu_torch.geometry import (
        initialize_directions, make_shift_vector)
    from stylegan_directions_face_reenactment_tpu_torch.models.deca import calculate_shapemodel
    from stylegan_directions_face_reenactment_tpu_torch.models.direction_matrix import (
        direction_matrix_forward)
    from stylegan_directions_face_reenactment_tpu_torch.models.stylegan2 import (
        generator_forward, mapping, mean_latent, n_latent_for, style_to_wplus, synthesis)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
        generate_image, make_reenact_fn)
    from stylegan_directions_face_reenactment_tpu_torch.weights import (
        init_deca, init_direction_matrix, init_generator)

    def build(device):
        return (init_generator(0, SIZE, 512, 8, CM, device=device),
                init_direction_matrix(1, 512, 15, w_plus=True, num_layers=8, device=device),
                init_deca(2, device=device))

    g, a, deca = build(None)           # the default device: the card
    need(g.input.input.is_cuda, "the generator did not land on the card")
    spec = initialize_directions("voxceleb", 15, 6.0)
    n_lat = n_latent_for(SIZE)
    with torch.inference_mode():
        trunc = mean_latent(g, torch.Generator().manual_seed(3), 4096)
        z = torch.randn(1, 512, generator=torch.Generator().manual_seed(4)).cuda()
        source_code = style_to_wplus(g, [mapping(g, z)])
        source_img = synthesis(g, source_code)
        params_source, angles_source = calculate_shapemodel(deca, source_img)
        targets = []
        for i, t in enumerate(REQUESTS):
            zt = torch.randn(t, 512, generator=torch.Generator().manual_seed(10 + i)).cuda()
            img, _ = generator_forward(g, [zt], truncation=0.7, truncation_latent=trunc)
            targets.append(img.clamp(-1, 1))
    torch.cuda.synchronize()

    def serve(fn, tag, keep_first):
        """One round: the three requests, each answered (synchronized) before
        the next. Returns the seconds spent inside the requests; the output
        checks run outside them."""
        busy = 0.0
        for r, tgt in enumerate(targets):
            reset_counts()
            t0 = time.perf_counter()
            img, lat, p_t, a_t = fn(source_code, params_source, angles_source, tgt)
            torch.cuda.synchronize()
            busy += time.perf_counter() - t0
            got = read_counts()
            need(got == (K1_PER_REQUEST, K2_PER_REQUEST, 0),
                 f"{tag} request {r}: K1/K2/K3 launched {got} times, expected "
                 f"{K1_PER_REQUEST}/{K2_PER_REQUEST}/0")
            launches[0] += got[0]
            launches[1] += got[1]
            t = tgt.shape[0]
            need(tuple(img.shape) == (t, SIZE, SIZE, 3) and
                 tuple(lat.shape) == (t, n_lat, 512),
                 f"{tag} request {r}: shapes {tuple(img.shape)} {tuple(lat.shape)}")
            need(bool(torch.isfinite(img).all()) and bool(torch.isfinite(lat).all()),
                 f"{tag} request {r}: non-finite output")
            if r == 0 and keep_first:
                first[tag] = (img[:2].float().cpu(), lat[:2].float().cpu(),
                              {k: v[:2].cpu() for k, v in p_t.items()}, a_t[:2].cpu())
        return busy

    results, launches, first = {}, [0, 0], {}
    frames = sum(REQUESTS)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        fn = make_reenact_fn(g, a, deca, spec, truncation=0.7, truncation_latent=trunc,
                             compute_dtype=dtype, return_target_params=True)
        torch.cuda.reset_peak_memory_stats()
        serve(fn, tag, keep_first=True)                 # warm-up round
        rates, t_start = [], time.perf_counter()
        while len(rates) < MIN_ROUNDS or time.perf_counter() - t_start < WINDOW_S:
            rates.append(frames / serve(fn, tag, keep_first=False))
        rates.sort()
        med = statistics.median(rates)
        peak = torch.cuda.max_memory_allocated()
        results[tag] = {"fps": med, "fps_min": rates[0], "fps_max": rates[-1],
                        "rounds": len(rates), "peak_bytes": peak}
        print(f"[slice] {tag}: median {med:.2f} frames/s over {len(rates)} rounds of "
              f"requests {REQUESTS} in {time.perf_counter() - t_start:.2f} s (min "
              f"{rates[0]:.2f}, max {rates[-1]:.2f}; host clock inside the requests, "
              f"each ending in a synchronize; after a warm-up round); peak memory "
              f"{peak / 2**30:.3f} GiB; K1/K2 launches {K1_PER_REQUEST}/"
              f"{K2_PER_REQUEST} a request")

    # frames 0-1 of the first request against the same weights on the CPU,
    # where the plain versions run, in both dtypes
    cg, ca, cdeca = build("cpu")
    want = {}
    for dtype in (torch.float32, torch.bfloat16):
        cpu_fn = make_reenact_fn(cg, ca, cdeca, spec, truncation=0.7,
                                 truncation_latent=trunc.cpu(), compute_dtype=dtype,
                                 device="cpu")
        want[str(dtype)[6:]] = cpu_fn(source_code.cpu(),
                                      {k: v.cpu() for k, v in params_source.items()},
                                      angles_source.cpu(), targets[0][:2].cpu())
    want_img, want_lat = want["float32"]
    got_img, got_lat = first["float32"][:2]
    img_err = float((got_img - want_img).abs().max())
    lat_err = float((got_lat - want_lat).abs().max())
    # the CPU-vs-JAX bounds of the repo's tests: images rtol 1e-3, atol
    # 2e-4·max|image|; latents rtol 1e-4, atol 1e-4·max|latent|
    img_ok = allclose_scaled(got_img, want_img, 1e-3, 2e-4)
    lat_ok = allclose_scaled(got_lat, want_lat, 1e-4, 1e-4)
    print(f"[slice] card vs CPU, frames 0-1 of request 1, float32: image max abs err "
          f"{img_err:.3g} of max|image| {float(want_img.abs().max()):.3g} "
          f"(rtol 1e-3, atol 2e-4·max: {'ok' if img_ok else 'FAIL'}); latent "
          f"{lat_err:.3g} (rtol 1e-4, atol 1e-4·max: {'ok' if lat_ok else 'FAIL'})")
    need(img_ok and lat_ok, "the card disagrees with the CPU")
    # bf16 rounds in other places on the card (cuDNN) and on the CPU, as the
    # port and the JAX package do (tests/test_torch_reenact.py); held stage
    # by stage (see BF16_DECA)
    bf_img, bf_lat, bf_p, bf_ang = first["bfloat16"]
    drift = mean_rel(bf_img, got_img)
    cpu_drift = mean_rel(want["bfloat16"][0], want_img)
    whole = mean_rel(bf_img, want["bfloat16"][0])
    with torch.inference_mode():
        cpu_p, _ = calculate_shapemodel(cdeca, targets[0][:2].cpu(),
                                        compute_dtype=torch.bfloat16)
        deca16 = mean_rel(torch.cat([bf_p[k] for k in sorted(bf_p)], dim=1),
                          torch.cat([cpu_p[k] for k in sorted(cpu_p)], dim=1))
        # dp -> A -> truncation in float32 from the card's coefficients, then
        # the CPU's bf16 synthesis
        ps2 = {k: v.cpu().expand((2,) + tuple(v.shape[1:])) for k, v in params_source.items()}
        shift = direction_matrix_forward(ca, make_shift_vector(
            spec, ps2, bf_p, angles_source.cpu().expand(2, 3), bf_ang))
        img_c, lat_c = generate_image(
            cg, source_code.cpu().expand((2,) + tuple(source_code.shape[1:])),
            truncation=0.7, truncation_latent=trunc.cpu(), shift_code=shift,
            input_is_latent=True, return_latents=True, compute_dtype=torch.bfloat16)
    lat16_ok = allclose_scaled(bf_lat, lat_c, 1e-4, 1e-4)
    synth16 = mean_rel(bf_img, img_c)
    print(f"[slice] bf16, frames 0-1 of request 1, mean relative drift: card vs card "
          f"float32 {drift:.4f} (limit {BF16_DRIFT}; CPU bf16 vs CPU float32 "
          f"{cpu_drift:.4f}; card vs CPU bf16 end to end {whole:.4f}, not held); card "
          f"vs CPU bf16 stage by stage: DECA coefficients {deca16:.4f} (limit "
          f"{BF16_DECA}), latents from the card's coefficients rtol 1e-4, atol "
          f"1e-4·max: {'ok' if lat16_ok else 'FAIL'}, synthesis from the card's latents "
          f"{synth16:.4f} (limit {BF16_SYNTH})")
    need(drift < BF16_DRIFT, "the bf16 path drifted from float32")
    need(deca16 < BF16_DECA and lat16_ok and synth16 < BF16_SYNTH,
         "the card's bf16 path disagrees with the CPU's")
    phase_breakdown(g, a, deca, spec, trunc,
                    (source_code, params_source, angles_source), targets[0])
    return results, launches


def _category(kernel_name):
    n = kernel_name.lower()
    if "fcb_" in n:
        return "K3 fused conv block"
    if "upfirdn2d_kernel" in n:
        return "K1 upfirdn2d"
    if "bias_act_bwd" in n:
        return "K2-bwd fused bias-act backward"
    if "bias_act" in n:
        return "K2 fused bias-act"
    if any(s in n for s in ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad",
                            "fft", "winograd", "mult_and_sum_complex")):
        return "convolution (cuDNN)"
    if any(s in n for s in ("gemm", "cutlass", "sm90_", "matmul", "nvjet")):
        return "matmul"
    if any(s in n for s in ("elementwise", "vectorized", "reduce", "copy", "fill")):
        return "elementwise/reduce/copy"
    return "other"


def phase_breakdown(g, a, deca, spec, trunc, source, tgt):
    """Where one request of 16 frames spends the card's time: the stages by
    CUDA events (with the extra peak memory each takes), the kernels by
    torch.profiler, and the device's busy share of the request's wall time."""
    from stylegan_directions_face_reenactment_tpu_torch.geometry import make_shift_vector
    from stylegan_directions_face_reenactment_tpu_torch.models.deca import calculate_shapemodel
    from stylegan_directions_face_reenactment_tpu_torch.models.direction_matrix import (
        direction_matrix_forward)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
        generate_image, make_reenact_fn)
    code, ps, angs = source
    t = tgt.shape[0]
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        align = None if dtype == torch.float32 else dtype
        with torch.inference_mode():
            p_t, a_t = calculate_shapemodel(deca, tgt, compute_dtype=align)
            ps_t = {k: v.expand((t,) + tuple(v.shape[1:])) for k, v in ps.items()}
            shift = direction_matrix_forward(
                a, make_shift_vector(spec, ps_t, p_t, angs.expand(t, 3), a_t))
            codes = code.expand((t,) + tuple(code.shape[1:]))
            stages = {
                "DECA encode (resize 256->224, ResNet-50)":
                    lambda: calculate_shapemodel(deca, tgt, compute_dtype=align),
                "synthesis (shift, truncation, StyleGAN2-256)":
                    lambda: generate_image(g, codes, truncation=0.7,
                                           truncation_latent=trunc, shift_code=shift,
                                           input_is_latent=True, compute_dtype=dtype),
            }
            for name, fn in stages.items():
                stage_ms(tag, name, fn, t)
        fn = make_reenact_fn(g, a, deca, spec, truncation=0.7, truncation_latent=trunc,
                             compute_dtype=dtype)
        profile_request(tag, f"one request of {t} frames", lambda: fn(code, ps, angs, tgt))


def stage_ms(tag, name, fn, frames, reps=10):
    """A stage's ms by CUDA events and the extra peak memory one call takes."""
    ms = time_ms(fn, reps=reps)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    print(f"[breakdown] {tag} {name}, {frames} frames: {ms:.3f} ms, extra peak "
          f"memory {extra / 2**30:.3f} GiB")
    return ms, extra


def profile_request(tag, label, run):
    """Device time by kernel class and the busy share of one warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_cat, n_kernels, others = {}, 0, []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        # device-side events only: a CPU range (an aten op, an autograd
        # Function) is credited with the kernels it launched as well, and a
        # user annotation on the device's timeline (Adam's step) spans them
        if dev > 0 and e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            cat = _category(e.key)
            per_cat[cat] = per_cat.get(cat, 0.0) + dev
            n_kernels += e.count
            if cat == "other":
                others.append((dev, e.key))
    busy = sum(per_cat.values())
    print(f"[breakdown] {tag} {label} under the profiler: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f} %, idle {100 - 100 * busy / wall_us:.1f} %), "
          f"{n_kernels} kernel launches")
    for cat, us in sorted(per_cat.items(), key=lambda kv: -kv[1]):
        print(f"[breakdown] {tag}   {cat}: {us / 1e3:.3f} ms "
              f"({100 * us / max(busy, 1e-9):.1f} % of device time)")
    for us, key in sorted(others, reverse=True)[:4]:
        print(f"[breakdown] {tag}     other: {us / 1e3:.3f} ms {key[:100]}")


def build_slice2_nets(device):
    """The served nets from their seeds: generator, A, DECA, S3FD, 2DFAN4."""
    from stylegan_directions_face_reenactment_tpu_torch.weights import (
        init_deca, init_direction_matrix, init_fan, init_generator, init_s3fd)
    return (init_generator(0, SIZE, 512, 8, CM, device=device),
            init_direction_matrix(1, 512, 15, w_plus=True, num_layers=8, device=device),
            init_deca(2, device=device), init_s3fd(5, device=device),
            init_fan(6, 4, device=device))


def counts():
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import fused_bias_act_cuda
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_conv_block import (
        fused_conv_block_cuda)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import upfirdn2d_cuda
    return (upfirdn2d_cuda, fused_bias_act_cuda, fused_conv_block_cuda)


def bwd_counts():
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
        fused_bias_act_bwd_cuda)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
        upfirdn2d_bwd_cuda)
    return (upfirdn2d_bwd_cuda, fused_bias_act_bwd_cuda)


def reset_counts():
    for k in counts() + bwd_counts():
        k.launches = 0
    bwd_counts()[0].down2_launches = 0


def read_counts():
    return tuple(k.launches for k in counts())


def read_bwd_counts():
    """(K1 backward, of which down = 2, K2-bwd) launches."""
    k1b, k2b = bwd_counts()
    return (k1b.launches, k1b.down2_launches, k2b.launches)


def flips_explained(hm_card, hm_cpu, atol):
    """(B, 68) mask of landmarks whose card and CPU peaks may differ: the two
    argmax cells hold values within ``atol`` on the card, or, at one cell, a
    neighbour difference that sets the ±0.25 step is within ``atol``."""
    b, h, w, n = hm_card.shape
    fc = hm_card.permute(0, 3, 1, 2).reshape(b, n, h * w)
    fp = hm_cpu.permute(0, 3, 1, 2).reshape(b, n, h * w)
    ic, ip = fc.argmax(-1), fp.argmax(-1)
    near_tie = (fc.gather(2, ic[..., None]) - fc.gather(2, ip[..., None]))[..., 0] <= atol

    def step_ambiguous(flat, idx):
        y, x = idx // w, idx % w
        def at(dy, dx):
            yy, xx = (y + dy).clamp(0, h - 1), (x + dx).clamp(0, w - 1)
            return flat.gather(2, (yy * w + xx)[..., None])[..., 0]
        return ((at(0, 1) - at(0, -1)).abs() <= atol) | ((at(1, 0) - at(-1, 0)).abs() <= atol)

    return torch.where(ic == ip, step_ambiguous(fc, ic), near_tie)


def phase_slice2():
    """The default per-frame path on raw frames, float32 and bf16."""
    from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
    from stylegan_directions_face_reenactment_tpu_torch.models.face import (
        box_to_center_scale, crop_faces, detect_faces, fan_forward, ffhq_crop_device,
        heatmaps_to_landmarks, landmarks_to_image_coords, s3fd_forward,
        select_reference_face)
    from stylegan_directions_face_reenactment_tpu_torch.models.stylegan2 import (
        mapping, mean_latent, n_latent_for, style_to_wplus, synthesis)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
        make_fused_reenact_fn, make_reenact_fn, reenact_batch, source_shape)

    g, a, deca, sfd, fan = build_slice2_nets(None)
    need(fan.conv1.weight.is_cuda and sfd.conv1_1.weight.is_cuda,
         "the face nets did not land on the card")
    spec = initialize_directions("voxceleb", 15, 6.0)
    n_lat = n_latent_for(SIZE)
    with torch.inference_mode():
        trunc = mean_latent(g, torch.Generator().manual_seed(3), 4096)
        z = torch.randn(1, 512, generator=torch.Generator().manual_seed(4)).cuda()
        source_code = style_to_wplus(g, [mapping(g, z)])
        params_source, angles_source = source_shape(deca, synthesis(g, source_code), fan, sfd)
    src = (source_code, params_source, angles_source)
    gen = torch.Generator().manual_seed(20)
    # raw uint8 frames, uploaded before the timed requests
    frames = [torch.randint(0, 256, (t,) + FRAME_HW + (3,), generator=gen,
                            dtype=torch.uint8).cuda() for t in REQUESTS]
    torch.cuda.synchronize()
    expect = (K1_PER_REQUEST, K2_PER_REQUEST, K3_PER_REQUEST)

    def serve(fn, tag):
        busy = 0.0
        for r, fr in enumerate(frames):
            reset_counts()
            t0 = time.perf_counter()
            reen, ok, in_frame, pts = fn(*src, fr)
            torch.cuda.synchronize()
            busy += time.perf_counter() - t0
            got = read_counts()
            need(got == expect, f"{tag} request {r}: K1/K2/K3 launched {got} times, "
                 f"expected {expect}")
            for i in range(3):
                launches[i] += got[i]
            t = fr.shape[0]
            need(tuple(reen.shape) == (t, SIZE, SIZE, 3) and reen.dtype == torch.uint8,
                 f"{tag} request {r}: reenacted {tuple(reen.shape)} {reen.dtype}")
            need(tuple(pts.shape) == (t, 68, 2) and pts.dtype == torch.float32
                 and bool(torch.isfinite(pts).all()),
                 f"{tag} request {r}: landmarks {tuple(pts.shape)} {pts.dtype} not finite "
                 "float32")
            need(ok.shape == (t,) and in_frame.shape == (t,), f"{tag} request {r}: masks")
            oks[tag] = oks.get(tag, 0) + int(ok.sum())
        return busy

    results, launches, oks = {}, [0, 0, 0], {}
    frames_n = sum(REQUESTS)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        fn = make_fused_reenact_fn(g, a, deca, spec, sfd, fan, truncation=0.7,
                                   truncation_latent=trunc, compute_dtype=dtype,
                                   fan_params=fan, s3fd_params=sfd, outputs="reenact")
        torch.cuda.reset_peak_memory_stats()
        serve(fn, tag)                                  # warm-up round
        rates, t_start = [], time.perf_counter()
        while len(rates) < MIN_ROUNDS2 or time.perf_counter() - t_start < WINDOW2_S:
            rates.append(frames_n / serve(fn, tag))
        rates.sort()
        med = statistics.median(rates)
        peak = torch.cuda.max_memory_allocated()
        results[tag] = {"fps": med, "fps_min": rates[0], "fps_max": rates[-1],
                        "rounds": len(rates), "peak_bytes": peak}
        print(f"[slice2] {tag}: median {med:.2f} frames/s over {len(rates)} rounds of "
              f"requests {REQUESTS} of {FRAME_HW[0]}x{FRAME_HW[1]} uint8 frames in "
              f"{time.perf_counter() - t_start:.2f} s (min {rates[0]:.2f}, max "
              f"{rates[-1]:.2f}; host clock inside the requests, frames already on the "
              f"card); peak memory {peak / 2**30:.3f} GiB; K1/K2/K3 launches "
              f"{'/'.join(map(str, expect))} a request; frames passing the detector "
              f"gate: {oks[tag]} (the whole-frame fallback and the -180 sentinel for "
              f"the rest)")

    # the reuse-landmark paths, one request each (float32)
    fr0 = frames[0]
    fused_reuse = make_fused_reenact_fn(g, a, deca, spec, sfd, fan, truncation=0.7,
                                        truncation_latent=trunc, reuse_landmarks=True,
                                        outputs="full")
    reset_counts()
    reen_r, lat_r, crops_u8, ok_r, _, _ = fused_reuse(*src, fr0)
    torch.cuda.synchronize()
    got = read_counts()
    need(got == (K1_PER_REQUEST, K2_PER_REQUEST, K3_PER_PASS),
         f"fused reuse_landmarks request: K1/K2/K3 launched {got} times")
    crops_gan = crops_u8.float() / 127.5 - 1.0
    rs = torch.Generator().manual_seed(21)
    planted = (torch.rand(fr0.shape[0], 68, 2, generator=rs) * 110 + 70).cuda()
    ok_all = torch.ones(fr0.shape[0], dtype=torch.bool, device="cuda")
    reuse_fn = make_reenact_fn(g, a, deca, spec, truncation=0.7, truncation_latent=trunc,
                               reuse_landmarks=True, return_target_params=True)
    reset_counts()
    img_p, lat_p, pt_p, at_p = reuse_fn(*src, crops_gan, planted, ok_all)
    torch.cuda.synchronize()
    got_p = read_counts()
    need(got_p == (K1_PER_REQUEST, K2_PER_REQUEST, 0),
         f"make_reenact_fn(reuse_landmarks) request: K1/K2/K3 launched {got_p} times")
    need(bool((at_p != -180.0).all()) and bool((pt_p["pose"].abs().sum(1) > 0).all()),
         "planted landmarks with ok=True must give coefficients, not the sentinel")
    align_fn = make_reenact_fn(g, a, deca, spec, truncation=0.7, truncation_latent=trunc,
                               fan_params=fan, s3fd_params=sfd)
    reset_counts()
    img_a, _ = align_fn(*src, crops_gan)
    torch.cuda.synchronize()
    got_a = read_counts()
    need(got_a == (K1_PER_REQUEST, K2_PER_REQUEST, K3_PER_PASS),
         f"make_reenact_fn(fan, s3fd) request: K1/K2/K3 launched {got_a} times")
    print(f"[slice2] reuse paths, request 1: fused reuse_landmarks K1/K2/K3 {got} "
          f"(frames passing the gate {int(ok_r.sum())}); make_reenact_fn with planted "
          f"in-crop landmarks and ok=True {got_p} (kpt68 warp on every frame; angles "
          f"{[round(float(v), 2) for v in at_p[0]]}); make_reenact_fn(fan, s3fd) on the "
          f"crops {got_a}")

    # frames 0-1 of request 1, float32, stage by stage against the CPU
    full = make_fused_reenact_fn(g, a, deca, spec, sfd, fan, truncation=0.7,
                                 truncation_latent=trunc, fan_params=fan,
                                 s3fd_params=sfd, outputs="full")
    reen_f, lat_f, crops_f, ok_f, in_f, pts_f = full(*src, fr0)
    with torch.inference_mode():
        imgs = fr0.float()
        boxes, valid = detect_faces(sfd, imgs, subtract_mean=False)
        best, ok = select_reference_face(boxes.float(), valid)
        center, scale = box_to_center_scale(best)
        crops01 = crop_faces(imgs, center, scale, 256) / 255.0
        hm = fan_forward(fan, crops01)[-1].float()
        pts = landmarks_to_image_coords(heatmaps_to_landmarks(hm), center, scale)
        crops, _ = ffhq_crop_device(imgs, pts, 256)
        heads = s3fd_forward(sfd, imgs[:2])
    need(torch.equal(pts, pts_f) and torch.equal(crops.to(torch.uint8), crops_f),
         "the stage-wise run disagrees with the fused request on the card")
    cg, ca, cdeca, csfd, cfan = build_slice2_nets("cpu")
    with torch.inference_mode():
        heads_cpu = s3fd_forward(csfd, imgs[:2].cpu())
        head_err = max(float((h.cpu() - hc).abs().max() / hc.abs().max())
                       for h, hc in zip(heads, heads_cpu))
        head_ok = all(allclose_scaled(h.cpu(), hc, 1e-3, 1e-4) for h, hc in zip(heads, heads_cpu))
        hm_cpu = fan_forward(cfan, crops01[:2].cpu())[-1].float()
        hm_atol = 1e-4 * float(hm_cpu.abs().max())
        hm_ok = allclose_scaled(hm[:2].cpu(), hm_cpu, 1e-3, 1e-4)
        pts_cpu = landmarks_to_image_coords(heatmaps_to_landmarks(hm_cpu),
                                            center[:2].cpu(), scale[:2].cpu())
        differ = (pts_cpu != pts[:2].cpu()).any(-1)
        explained = flips_explained(hm[:2].cpu(), hm_cpu, hm_atol)
        crops_cpu, _ = ffhq_crop_device(imgs[:2].cpu(), pts[:2].cpu(), 256)
        crop_err = float((crops_cpu - crops[:2].cpu()).abs().max())
        want_img, want_lat = reenact_batch(
            cg, ca, cdeca, spec, source_code.cpu(),
            {k: v.cpu() for k, v in params_source.items()}, angles_source.cpu(),
            crops_f[:2].cpu().float() / 127.5 - 1.0, truncation=0.7,
            truncation_latent=trunc.cpu(), fan_params=cfan, s3fd_params=csfd)
        img_ok = allclose_scaled(reen_f[:2].cpu(), want_img, 1e-3, 2e-4)
        lat_ok = allclose_scaled(lat_f[:2].cpu(), want_lat, 1e-4, 1e-4)
        src_cpu = (source_code.cpu(), {k: v.cpu() for k, v in params_source.items()},
                   angles_source.cpu())
        want_p, want_lp = make_reenact_fn(
            cg, ca, cdeca, spec, truncation=0.7, truncation_latent=trunc.cpu(),
            reuse_landmarks=True, device="cpu")(
                *src_cpu, crops_gan[:2].cpu(), planted[:2].cpu(), ok_all[:2].cpu())
        reuse_ok = (allclose_scaled(img_p[:2].cpu(), want_p, 1e-3, 2e-4)
                    and allclose_scaled(lat_p[:2].cpu(), want_lp, 1e-4, 1e-4))
    print(f"[slice2] card vs CPU, frames 0-1 of request 1, float32, stage by stage: "
          f"SFD heads max err {head_err:.3g} of max|head| (rtol 1e-3, atol 1e-4*max: "
          f"{'ok' if head_ok else 'FAIL'}); FAN heatmaps on the card's crops "
          f"{float((hm[:2].cpu() - hm_cpu).abs().max()):.3g} (atol {hm_atol:.3g}: "
          f"{'ok' if hm_ok else 'FAIL'}); landmarks differing {int(differ.sum())} of 136, "
          f"all within a near-tie: {bool((~differ | explained).all())}; FFHQ crops from "
          f"the card's landmarks max diff {crop_err:.0f} (limit 1); the rest from the "
          f"card's crops: image {'ok' if img_ok else 'FAIL'}, latent "
          f"{'ok' if lat_ok else 'FAIL'}; planted-landmark request: "
          f"{'ok' if reuse_ok else 'FAIL'}")
    need(head_ok and hm_ok and bool((~differ | explained).all()) and crop_err <= 1.0
         and img_ok and lat_ok and reuse_ok, "the card disagrees with the CPU on slice 2")
    bf16_stages(sfd, fan, deca, (csfd, cfan, cdeca), imgs[:1], crops01[:2], crops_f[:2])
    need(bool(torch.isfinite(reen_f).all()) and bool(torch.isfinite(lat_f).all())
         and tuple(lat_f.shape) == (fr0.shape[0], n_lat, 512), "slice 2 outputs")
    phase_breakdown2(g, a, deca, sfd, fan, spec, trunc, src, fr0)
    return results, launches


def bf16_stages(sfd, fan, deca, cpu_nets, frames, crops01, crops_u8):
    """Slice 2's bf16 stages on the card against the CPU's bf16 on the same
    inputs (end to end the random-init chain amplifies last digits, as in
    slice 1): the SFD heads on the same raw frame, the FAN heatmaps on the
    same crops (relative to their max), DECA's coefficients from the same
    aligned 224s (the card's bf16 SFD + FAN alignment of the card's FFHQ
    crops, taken as ok so that no coefficient is zeroed)."""
    from stylegan_directions_face_reenactment_tpu_torch.models.deca import calculate_shapemodel
    from stylegan_directions_face_reenactment_tpu_torch.models.face import (
        fan_forward, s3fd_forward)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import make_fan_align
    csfd, cfan, cdeca = cpu_nets
    bf = torch.bfloat16
    t0 = time.perf_counter()
    with torch.inference_mode():
        heads = s3fd_forward(sfd, frames.to(bf))
        heads_cpu = s3fd_forward(csfd, frames.cpu().to(bf))
        sfd16 = max(mean_rel(h.cpu(), hc) for h, hc in zip(heads, heads_cpu))
        hm = fan_forward(fan, crops01.to(bf))[-1].float().cpu()
        hm_cpu = fan_forward(cfan, crops01.cpu().to(bf))[-1].float()
        fan16 = mean_rel(hm, hm_cpu)
        fan16_max = float((hm - hm_cpu).abs().max() / hm_cpu.abs().max())
        crops_gan = crops_u8.float() / 127.5 - 1.0
        aligned, _ = make_fan_align(fan, sfd, compute_dtype=bf, return_ok=True)(
            (crops_gan + 1.0) / 2.00001)
        ok = torch.ones(crops_gan.shape[0], dtype=torch.bool)
        p, _ = calculate_shapemodel(deca, crops_gan, align_fn=lambda _: (aligned, ok.cuda()),
                                    compute_dtype=bf)
        p_cpu, _ = calculate_shapemodel(cdeca, crops_gan.cpu(),
                                        align_fn=lambda _: (aligned.cpu(), ok), compute_dtype=bf)
        deca16 = mean_rel(torch.cat([p[k].cpu() for k in sorted(p)], dim=1),
                          torch.cat([p_cpu[k] for k in sorted(p_cpu)], dim=1))
    print(f"[slice2] card vs CPU bf16, stage by stage (mean relative drift): SFD heads "
          f"on raw frame 0, worst head {sfd16:.4f} (limit {BF16_SFD}); FAN heatmaps on "
          f"crops 0-1 {fan16:.4f} (limit {BF16_FAN}), max |diff| {fan16_max:.4f} of "
          f"max|heatmap| (limit {BF16_FAN_MAX}); DECA coefficients from the same aligned "
          f"224s {deca16:.4f} (limit {BF16_DECA2}); {time.perf_counter() - t0:.1f} s")
    need(sfd16 < BF16_SFD and fan16 < BF16_FAN and fan16_max < BF16_FAN_MAX
         and deca16 < BF16_DECA2, "the card's bf16 slice 2 disagrees with the CPU's")


def phase_breakdown2(g, a, deca, sfd, fan, spec, trunc, src, fr):
    """Where one request of 16 raw frames spends the card's time, by stage
    (CUDA events, extra peak memory) and by kernel class (torch.profiler)."""
    from stylegan_directions_face_reenactment_tpu_torch.geometry import make_shift_vector
    from stylegan_directions_face_reenactment_tpu_torch.models.deca import calculate_shapemodel
    from stylegan_directions_face_reenactment_tpu_torch.models.direction_matrix import (
        direction_matrix_forward)
    from stylegan_directions_face_reenactment_tpu_torch.models.face import (
        box_to_center_scale, crop_faces, detect_faces, fan_forward, ffhq_crop_device,
        heatmaps_to_landmarks, landmarks_to_image_coords, select_reference_face)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
        generate_image, make_fan_align, make_fused_reenact_fn)
    code, ps, angs = src
    t = fr.shape[0]
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        align = None if dtype == torch.float32 else dtype
        with torch.inference_mode():
            imgs = fr.float()
            det_in = imgs if align is None else imgs.to(align)
            boxes, valid = detect_faces(sfd, det_in, subtract_mean=False)
            center, scale = box_to_center_scale(select_reference_face(boxes.float(), valid)[0])
            crops01 = crop_faces(imgs, center, scale, 256) / 255.0
            fan_in = crops01 if align is None else crops01.to(align)
            hm = fan_forward(fan, fan_in)[-1].float()
            pts = landmarks_to_image_coords(heatmaps_to_landmarks(hm), center, scale)
            crops, _ = ffhq_crop_device(imgs, pts, 256)
            crops_gan = crops / 127.5 - 1.0
            aligner = make_fan_align(fan, sfd, compute_dtype=align, return_ok=True)
            aligned, ok = aligner((crops_gan + 1.0) / 2.00001)
            p_t, a_t = calculate_shapemodel(deca, crops_gan, align_fn=lambda _: (aligned, ok),
                                            compute_dtype=align)
            ps_t = {k: v.expand((t,) + tuple(v.shape[1:])) for k, v in ps.items()}
            shift = direction_matrix_forward(
                a, make_shift_vector(spec, ps_t, p_t, angs.expand(t, 3), a_t))
            codes = code.expand((t,) + tuple(code.shape[1:]))
            stages = {
                "SFD on the raw frames (562x1000)":
                    lambda: detect_faces(sfd, det_in, subtract_mean=False),
                "FAN on the 256 crops (preprocessing pass, 56 K3 calls)":
                    lambda: fan_forward(fan, fan_in),
                "FFHQ crop (device resample)": lambda: ffhq_crop_device(imgs, pts, 256),
                "SFD + FAN alignment on the crops (56 K3 calls, kpt68 warp)":
                    lambda: aligner((crops_gan + 1.0) / 2.00001),
                "DECA encode (ResNet-50 on the aligned 224)":
                    lambda: calculate_shapemodel(deca, crops_gan,
                                                 align_fn=lambda _: (aligned, ok),
                                                 compute_dtype=align),
                "synthesis (shift, truncation, StyleGAN2-256)":
                    lambda: generate_image(g, codes, truncation=0.7,
                                           truncation_latent=trunc, shift_code=shift,
                                           input_is_latent=True, compute_dtype=dtype),
            }
            for name, fn in stages.items():
                stage_ms(tag, f"[slice2] {name}", fn, t, reps=3)
        fused = make_fused_reenact_fn(g, a, deca, spec, sfd, fan, truncation=0.7,
                                      truncation_latent=trunc, compute_dtype=dtype,
                                      fan_params=fan, s3fd_params=sfd, outputs="reenact")
        profile_request(tag, f"[slice2] one request of {t} raw frames",
                        lambda: fused(code, ps, angs, fr))


def build_slice3_nets(device):
    """Slice 2's nets plus the seeded e4e (IR-SE50 at 256, 14 styles, its
    residual branches damped by ``E4E_BN2_SCALE``) and LPIPS/AlexNet."""
    from stylegan_directions_face_reenactment_tpu_torch.utils.device import resolve_device
    from stylegan_directions_face_reenactment_tpu_torch.weights import init_e4e, init_lpips
    e4e = init_e4e(7, SIZE, device="cpu")
    with torch.no_grad():
        for blk in e4e.body:
            blk.res_layer[4].weight.mul_(E4E_BN2_SCALE)
    return build_slice2_nets(device) + (e4e.to(resolve_device(device)),
                                        init_lpips(8, device=device))


def fresh(t, device):
    """A normal (not inference-mode) copy of ``t`` on ``device``: autograd
    may save it."""
    return t.detach().to(device).clone()


def pti_first_step(g, lp, code, real, trunc):
    """(loss, gradients of the tuned parameters) of one PTI step on g's
    device."""
    from stylegan_directions_face_reenactment_tpu_torch.pipeline.pti import (
        pti_objective, split_tunable)
    dev = g.input.input.device
    code, real, trunc = (fresh(t, dev) for t in (code, real, trunc))
    g = copy.deepcopy(g)
    g.requires_grad_(False)
    tuned = split_tunable(g)
    for p in tuned:
        p.requires_grad_(True)
    total, _, _ = pti_objective(g, code, real, lp, trunc)
    total.backward()
    return float(total.detach()), [p.grad.cpu() for p in tuned]


def phase_slice3():
    """Source set-up on the card: e4e inversion → 200 PTI steps → source
    DECA, float32, then one request served from its outputs."""
    from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
    from stylegan_directions_face_reenactment_tpu_torch.models.stylegan2 import (
        mapping, mean_latent, style_to_wplus, synthesis)
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
        fused_bias_act_calls, pti_backward_calls, upfirdn2d_calls)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
        invert_image, make_fused_reenact_fn, optimize_g, setup_source, source_shape)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
        source_setup as source_setup_mod)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline.pti import TUNED_CONV_RANGE

    g, a, deca, sfd, fan, e4e, lp = build_slice3_nets(None)
    need(e4e.input_layer[0].weight.is_cuda and lp.net.layers[0].weight.is_cuda,
         "e4e and LPIPS did not land on the card")
    with torch.inference_mode():
        trunc = mean_latent(g, torch.Generator().manual_seed(3), 4096)
        z = torch.randn(1, 512, generator=torch.Generator().manual_seed(30)).cuda()
        face = synthesis(g, style_to_wplus(g, [mapping(g, z)])).clamp(-1, 1)

    def prep(frames):
        # the source is a generated 256 face already: no detection, ok set
        return frames[0][None], np.ones(1, bool)

    kw = dict(truncation_latent=trunc, optimize_generator=True, lpips_params=lp,
              lr=PTI_LR, fan_params=fan, s3fd_params=sfd)
    setup_source(g, e4e, deca, [face[0]], prep, opt_steps=2, **kw)     # warm-up
    before = {k: v.clone() for k, v in g.state_dict().items()}
    # optimize_g is wrapped here, in this script only, to keep the loss dict
    # that setup_source drops and the wall time of the 200 steps
    real_optimize_g, kept = source_setup_mod.optimize_g, {}

    def kept_optimize_g(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_optimize_g(*args, **kwargs)
        torch.cuda.synchronize()
        kept["s"], kept["losses"] = time.perf_counter() - t0, out[1]
        return out

    source_setup_mod.optimize_g = kept_optimize_g
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        src_img, code, g_src, p_src, ang_src = setup_source(
            g, e4e, deca, [face[0]], prep, opt_steps=PTI_STEPS, **kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        fwd, bwd = read_counts(), read_bwd_counts()
    finally:
        source_setup_mod.optimize_g = real_optimize_g
    peak = torch.cuda.max_memory_allocated()

    pti = pti_backward_calls(SIZE, CM)
    per_step = {"K1": len(upfirdn2d_calls(SIZE, CM, 1)),
                "K1 backward up 1": sum(c.up == 1 for c in pti.upfirdn2d),
                "K1 backward down 2": sum(c.up == 2 for c in pti.upfirdn2d),
                "K2": len(fused_bias_act_calls(SIZE, CM, 1)),
                "K2-bwd": len(pti.fused_bias_act)}
    got = {"K1": fwd[0], "K1 backward up 1": bwd[0] - bwd[1], "K1 backward down 2": bwd[1],
           "K2": fwd[1], "K2-bwd": bwd[2]}
    print(f"[slice3] launches in setup_source ({PTI_STEPS} PTI steps): "
          + ", ".join(f"{k} {v} ({v / PTI_STEPS:g} a step, expected {per_step[k]})"
                      for k, v in got.items()) + f"; K3 {fwd[2]} (the source's FAN pass)")
    need(all(got[k] == PTI_STEPS * per_step[k] for k in got) and fwd[2] == K3_PER_PASS,
         f"slice 3 launches {got}, K3 {fwd[2]}: expected {per_step} a PTI step and "
         f"{K3_PER_PASS} K3")

    hist = kept["losses"]["loss_history"].cpu()
    print(f"[slice3] PTI loss history ({len(hist)} steps, 100*MSE + LPIPS): first "
          f"{float(hist[0]):.6g}, step {len(hist) // 4} {float(hist[len(hist) // 4]):.6g}, "
          f"step {len(hist) // 2} {float(hist[len(hist) // 2]):.6g}, last "
          f"{float(hist[-1]):.6g}; final MSE "
          f"{float(kept['losses']['l2_loss']):.6g}, LPIPS {float(kept['losses']['lpips_loss']):.6g}")
    need(len(hist) == PTI_STEPS and bool(torch.isfinite(hist).all())
         and float(hist[-1]) < float(hist[0]), "the PTI loss history is not finite and falling")
    need(all(torch.equal(v, before[k]) for k, v in g.state_dict().items()),
         "setup_source changed the caller's generator")
    lo, hi = TUNED_CONV_RANGE
    tuned_prefixes = tuple(f"convs.{i}." for i in range(lo, hi))
    changed = sorted(k for k, v in g_src.state_dict().items() if not torch.equal(v, before[k]))
    need(changed and all(k.startswith(tuned_prefixes) for k in changed)
         and all(f"convs.{i}.conv.weight" in changed for i in range(lo, hi)),
         f"the tuned generator changed {changed[:5]}..., not exactly convs[{lo}..{hi - 1}]")
    print(f"[slice3] the caller's generator is unchanged bit for bit; the tuned copy "
          f"differs in {len(changed)} tensors, all in convs[{lo}..{hi - 1}]; code "
          f"{tuple(code.shape)}, angles {[round(float(v), 3) for v in ang_src[0]]}")

    # times, warm (TF32 off): CUDA events for e4e and the source DECA, the
    # host clock around synchronized runs of PTI_RUN_STEPS steps
    with torch.no_grad():
        e4e_ms = time_ms(lambda: invert_image(src_img, e4e, g, truncation_latent=trunc,
                                              resynthesize=False), reps=10)
        deca_ms = time_ms(lambda: source_shape(deca, src_img, fan, sfd), reps=10)
    steps_ms = []
    for _ in range(PTI_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimize_g(g, code, src_img, lp, trunc, opt_steps=PTI_RUN_STEPS, lr=PTI_LR)
        torch.cuda.synchronize()
        steps_ms.append(1e3 * (time.perf_counter() - t0) / PTI_RUN_STEPS)
    steps_ms.sort()
    step_ms = statistics.median(steps_ms)
    times = {"e4e_ms": e4e_ms, "pti_step_ms": step_ms, "pti_step_min": steps_ms[0],
             "pti_step_max": steps_ms[-1], "pti_200_s": kept["s"], "deca_ms": deca_ms,
             "setup_s": setup_s, "peak_bytes": peak}
    print(f"[slice3] e4e inversion {e4e_ms:.3f} ms (CUDA events, 10 calls); PTI step "
          f"{step_ms:.3f} ms median of {PTI_RUNS} runs of {PTI_RUN_STEPS} steps (min "
          f"{steps_ms[0]:.3f}, max {steps_ms[-1]:.3f}; host clock, synchronized); the "
          f"{PTI_STEPS} steps of the set-up run {kept['s']:.3f} s; source DECA (SFD + FAN "
          f"alignment, ResNet-50) {deca_ms:.3f} ms; setup_source {setup_s:.3f} s; peak "
          f"memory {peak / 2**30:.3f} GiB")
    profile_request("float32", f"[slice3] {PTI_RUN_STEPS} PTI steps",
                    lambda: optimize_g(g, code, src_img, lp, trunc,
                                       opt_steps=PTI_RUN_STEPS, lr=PTI_LR))

    # the same weights on the CPU, where the plain versions run
    t0 = time.perf_counter()
    cg, _, _, _, _, ce4e, clp = build_slice3_nets("cpu")
    with torch.no_grad():
        _, code_cpu = invert_image(src_img.cpu(), ce4e, cg, truncation_latent=trunc.cpu(),
                                   resynthesize=False)
    code_err = float((code.cpu() - code_cpu).abs().max())
    code_ok = allclose_scaled(code.cpu(), code_cpu, 1e-4, 1e-4)
    card = pti_first_step(g, lp, code, src_img, trunc)
    cpu = pti_first_step(cg, clp, code, src_img, trunc)
    loss_ok = abs(card[0] - cpu[0]) <= 1e-4 * abs(cpu[0])
    # a noise weight's gradient is one scalar, a sum of g·noise over C·R²
    # pixels that largely cancel, so the 8 are held as one vector: rtol 1e-3,
    # atol 1e-2·max (read 6e-5 to 2.8e-3·max on an NVIDIA H100 80GB HBM3 at
    # 700 W; cuDNN's algorithm choices differ between processes); every
    # other tensor rtol 1e-3, atol 2e-3·max (read 5e-6 to 6.5e-4·max)
    noise = [torch.cat([t for t in grads if t.numel() == 1]) for grads in (card[1], cpu[1])]
    pairs = [(a, w) for a, w in zip(card[1], cpu[1]) if w.numel() > 1]
    grad_rel = max(float((a - w).abs().max() / w.abs().max()) for a, w in pairs)
    noise_rel = float((noise[0] - noise[1]).abs().max() / noise[1].abs().max())
    grads_ok = (allclose_scaled(noise[0], noise[1], 1e-3, 1e-2)
                and all(allclose_scaled(a, w, 1e-3, 2e-3) for a, w in pairs))
    hist_card = optimize_g(g, code, src_img, lp, trunc, opt_steps=CPU_PTI_STEPS,
                           lr=PTI_LR)[1]["loss_history"].cpu()
    hist_cpu = optimize_g(cg, code.cpu(), src_img.cpu(), clp, trunc.cpu(),
                          opt_steps=CPU_PTI_STEPS, lr=PTI_LR)[1]["loss_history"]
    hist_rel = float(((hist_card - hist_cpu).abs() / hist_cpu.abs()).max())
    print(f"[slice3] card vs CPU, float32: e4e code max abs err {code_err:.3g} of max|code| "
          f"{float(code_cpu.abs().max()):.3g} (rtol 1e-4, atol 1e-4*max: "
          f"{'ok' if code_ok else 'FAIL'}); first PTI step loss {card[0]:.7g} vs "
          f"{cpu[0]:.7g} (rtol 1e-4: {'ok' if loss_ok else 'FAIL'}), gradients of the "
          f"{len(card[1])} tuned tensors worst max err {grad_rel:.3g} of their max (rtol "
          f"1e-3, atol 2e-3*max), noise weights {noise_rel:.3g} of their max (rtol 1e-3, atol "
          f"1e-2*max): "
          f"{'ok' if grads_ok else 'FAIL'}; losses of "
          f"{CPU_PTI_STEPS} steps {[round(float(v), 4) for v in hist_card]} vs "
          f"{[round(float(v), 4) for v in hist_cpu]}, worst relative {hist_rel:.3g} (limit "
          f"1e-3: Adam's first step is near +-lr on every weight); "
          f"{time.perf_counter() - t0:.1f} s")
    need(code_ok and loss_ok and grads_ok and hist_rel <= 1e-3,
         "the card disagrees with the CPU on slice 3")

    # serve one request of raw frames from the set-up's outputs
    spec = initialize_directions("voxceleb", 15, 6.0)
    frames = torch.randint(0, 256, (BATCH,) + FRAME_HW + (3,),
                           generator=torch.Generator().manual_seed(31), dtype=torch.uint8).cuda()
    served = {}
    for tag, gen in (("tuned", g_src), ("untuned", g)):
        fn = make_fused_reenact_fn(gen, a, deca, spec, sfd, fan, truncation=0.7,
                                   truncation_latent=trunc, fan_params=fan, s3fd_params=sfd,
                                   outputs="full")
        served[tag] = fn(code, p_src, ang_src, frames)[0]
    torch.cuda.synchronize()
    reen = served["tuned"]
    diff = float((reen - served["untuned"]).abs().max())
    print(f"[slice3] one request of {BATCH} raw {FRAME_HW[0]}x{FRAME_HW[1]} frames from the "
          f"set-up's code, coefficients and tuned generator: {tuple(reen.shape)}, finite "
          f"{bool(torch.isfinite(reen).all())}; max |tuned - untuned| {diff:.4g}")
    need(tuple(reen.shape) == (BATCH, SIZE, SIZE, 3) and bool(torch.isfinite(reen).all())
         and diff > 0, "serving from the tuned generator failed")
    return times, fwd, bwd


def main():
    name, smi = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[setup] TF32 off for cuDNN and matmul in every phase, timing included")
    phase_build()
    worst = phase_parity()
    worst.update(phase_parity_bwd())
    timing = phase_timing(name)
    k3_breakdown()
    timing.update(phase_timing_bwd(name))
    results, launches = phase_slice()
    results2, launches2 = phase_slice2()
    times3, fwd3, bwd3 = phase_slice3()
    for label, res in (("slice 1, resize path", results),
                       ("slice 2, default path, 562x1000 raw frames", results2)):
        for tag, r in res.items():
            print(f"[result] {label}, {tag}: {r['fps']:.2f} frames/s (median of "
                  f"{r['rounds']} rounds, {r['fps_min']:.2f}-{r['fps_max']:.2f}), peak "
                  f"{r['peak_bytes']} bytes on {smi}")
    print(f"[result] slice 3, source set-up, float32: setup_source {times3['setup_s']:.3f} s "
          f"({PTI_STEPS} PTI steps {times3['pti_200_s']:.3f} s), PTI step "
          f"{times3['pti_step_ms']:.3f} ms ({times3['pti_step_min']:.3f}-"
          f"{times3['pti_step_max']:.3f}), e4e {times3['e4e_ms']:.3f} ms, source DECA "
          f"{times3['deca_ms']:.3f} ms, peak {times3['peak_bytes']} bytes on {smi}")
    launches = [launches[0] + launches2[0] + fwd3[0], launches[1] + launches2[1] + fwd3[1],
                launches2[2] + fwd3[2], bwd3[0], bwd3[2]]
    need(all(n > 0 for n in launches) and bwd3[1] > 0,
         f"a kernel of the main paths never launched: {launches}, K1 down 2 {bwd3[1]}")

    kernels = []
    for name_k, route, source, replaces, n in (
            ("upfirdn2d", "cuda", f"{PORT}/csrc/upfirdn2d.cu",
             "stylegan_directions_face_reenactment_tpu/ops/pallas_upfirdn.py:256",
             launches[0]),
            ("upfirdn2d_bwd", "cuda", f"{PORT}/csrc/upfirdn2d.cu",
             "stylegan_directions_face_reenactment_tpu/ops/pallas_upfirdn.py:273",
             launches[3]),
            ("fused_bias_act", "cuda", f"{PORT}/csrc/fused_bias_act.cu",
             "stylegan_directions_face_reenactment_tpu/ops/fused_act.py:92",
             launches[1]),
            ("fused_bias_act_bwd", "cuda", f"{PORT}/csrc/fused_bias_act.cu",
             "stylegan_directions_face_reenactment_tpu/ops/fused_act.py:106",
             launches[4]),
            ("fused_conv_block", "cuda", f"{PORT}/csrc/fused_conv_block.cu",
             "stylegan_directions_face_reenactment_tpu/ops/fused_conv_block.py:146",
             launches[2])):
        t = timing[(name_k, "float32")]
        kernels.append({
            "name": name_k, "route": route, "source": source, "replaces": replaces,
            "launches": n, "max_abs_err": worst[name_k], "ms": t["ms"],
            "host_us": t["host_us"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes"] / card_rates(name)[0]
                        >= t["ops"] / card_rates(name)[1] else "operations",
            "library_ms": t["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
