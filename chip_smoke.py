#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA card and the CUDA
toolkit. It imports the port (``stylegan_directions_face_reenactment_tpu_torch``)
and nothing of JAX or the JAX package. Phases, in order; any failure exits
non-zero without printing the last line:

1. device: the card's name, count, power limit;
2. build: K1 (upfirdn2d), K2 (fused bias-act), K3 (the FAN ConvBlock)
   and K4 (StyleGAN3's filtered leaky ReLU) from ``csrc/`` with nvcc, with each kernel's registers and shared memory;
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
   shapes of one PTI step (``ops/main_path.py::pti_backward_calls``);
8. the CLI (``cli/run_inference.py::main``) on the card at full width: the
   nets of slice 3 written as checkpoint files in the reference's layouts
   into a temporary directory that ``REENACT_PRETRAINED_ROOT`` names, so
   the loaders run; one source PNG and 32 target PNGs of 562×1000, black
   with a textured patch (S3FD's stride-4 face score gated on content, so
   the face lies on the patch; two patches sit on the top edge, so their
   FFHQ boxes leave the frame and take the host crop). Four runs: (a) the
   defaults (the fused loop, 200 PTI steps, float32) with
   ``--save_images --save_grid``, (b) ``--compute_dtype bfloat16
   --reuse_landmarks --video_content reenact --no-optimize_generator``,
   (c) ``--no-device_crop`` (the unfused loop), (d) a longer window of the
   fused loop: 160 targets (the 30 in-frame PNGs over and over, 10 chunks,
   no fallback) with ``--no-optimize_generator --save_images
   --save_grid``; each run's launches of
   every kernel against what its set-up, chunks and fallbacks should
   launch, the files it wrote, its wall time and the target loop's
   frames/s; run (a)'s first chunk against a direct
   ``make_fused_reenact_fn(..., outputs="reenact")`` call; run (a) also
   writes the video (OpenCV, fourcc ``mp4v``) and reads it back;
9. [edit] and [invert]: ``cli/run_facial_editing.py`` three ways and
   ``cli/invert_images.py`` on a fabricated tree, at full width, with exact
   launch counts and each held against a direct call;
10. K3's backward (``fused_conv_block_bwd``) against plain autograd at a
    FAN pass's shapes (B = 4), float32 and bf16, and its device time beside
    autograd through the cuDNN composition;
11. [grad]: frames that need a gradient through ``make_fan_align(fan,
    s3fd)`` and through ``estimate_landmarks`` on the card against the CPU,
    the parameters' ``.grad`` checked, and a float64 witness of how far
    float32 gradients of the random FAN land (``grad_witness``);
12. [flame]: ``deca_decode`` at B = 16 on FLAME at 5023 vertices, card
    against CPU, and its time;
13. [train]: training A at full width on the CLI phase's files plus a
    seeded IR-SE-50 file (each block's last batch-norm scale × 0.3): (a)
    ``cli/run_trainer.py::main`` synthetic at batch 12 for 4 steps with the
    evaluation at step 0 and a checkpoint at step 2, (b) paired for one
    epoch on a tree of generated frames and their codes (cached
    coefficients), each with its launches and files; S3FD's ok frames; the
    synthetic (float32 and bf16 synthesis) and paired steps timed, with
    exact launches a step (K3-bwd 0, no K3 plan made after the warm-up),
    peak memory and a profile; (c) one grads-only synthetic step at batch 2
    with ``fan_frame`` on the card against the CPU (``train_card_vs_cpu``).

14. [ddp] (data parallelism, ``parallel/mesh.py``): (a) the paired step
    (cached coefficients, batch 12) over an NCCL world of the cards present
    (at most 4; one on a one-card machine, where A's update must be
    bit-equal to the plain step's); (b) two gloo ranks on card 0, each half
    of a batch-12 paired and synthetic step, against the one-process steps
    at [train] (c)'s limits with its witness first; (c)
    ``run_trainer.main --n_devices`` over the cards when there are two or
    more. Per rank: launches a step, step ms, the all-reduce's ms, peak
    memory; the kernels held at the per-rank batch of 6;
15. [mesh]: ``make_mesh`` past the cards raises; ``make_fused_reenact_fn
    (mesh=...)`` over two slots (two cards, or card 0 twice) on a request
    of 16 raw frames against the one-device call, both timed;
16. [stats]: ``cli/extract_statistics.py::main`` on the CLI files, 64
    samples at batch 16, timed, and its first 16 draws card vs CPU;
17. [report]: ``cli/parity_report.py::main`` on the CLI target PNGs, 16
    frames of self-reenactment without PTI, timed, and 4 frames card vs
    CPU.

18. [serve] (the serving bundle, ``serving.py``): slice 2's nets with
    ``fan`` alignment exported with ``torch.export`` at a frame batch of 16
    in float32 and bf16 (the graph must call K1/K2/K3 as the operators
    ``sdfr::*``, 12/13/56 times), saved; a fresh process that must import
    no ``models`` or ``pipeline`` module loads both bundles and serves
    requests of 16, 16, 5 and 37 frames (exact launches a chunk), held
    against the live ``make_reenact_fn``; ``with_generator`` with a
    PTI-tuned generator; served against live frames/s in turns;
19. [heads]: the discriminator, the W+ encoder, the pSp heads,
    ``estimate_landmarks_3d`` with the full depth net and PTI's space
    regulariser on the card against the CPU, with every K1/K2 call of the
    discriminator and W+ encoder held against the plain versions.

20. [render] (the DECA renderer group): the seeded DECA with its detail
    branch, a texture space at the real width and FLAME's arrays over a
    torus of FLAME's size with a seam-split atlas; ``decode_deca(use_tex=True)`` at B = 16 on 224²
    images timed with its peak memory, launches and the rasterizer's chunk
    (and one UV rasterization at other chunks, which must give the same
    result), ``shape_visualization`` and ``deca_encode(with_detail=True)``
    at B = 16, and one frame card against CPU.

21. [k4] (K4, StyleGAN3's filtered leaky ReLU): ``sdfr::filtered_lrelu``
    against its plain version at every layer shape of the published
    StyleGAN3-T at a chunk of 16, float32 and bf16 (per-plane scales on
    every other layer), and each instantiation zero-padded to 24 taps at a
    small shape; on the same values channels-last, bit-equal to itself on
    NCHW; its device ms, host µs, call ms, plain ms and bound over a chunk's
    15 calls in both layouts (channels-last at the channel counts the
    synthesis pads to, NCHW at the published ones), with each plan's tile,
    group and plane walk; its launches (15, all channels-last), plans made
    (0) and planes prefetched (the sum its plans give) in a second
    StyleGAN3-T chunk through ``make_reenact_fn``, whose images are held
    against the plain version's synthesis of the same latents.

Phases 10-21 run last, so that the readings of 1-8 keep the conditions
they were first recorded in.

The last two lines are the kernels' numbers and ``{"ok": true, ...}``.
``python3 chip_smoke.py --only ddp mesh stats report`` runs phases 14-17
alone (``ddp_cards``: [ddp] (a) and (c), for a call with four cards), and
``--only serve heads`` phases 18-19, ``--only render`` phase 20 and
``--only k4`` phase 21, with no last line.
"""

import copy
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

PORT = "stylegan_directions_face_reenactment_tpu_torch"
# the CLI phase writes its checkpoint files here; the port's registry reads
# the variable when it is first imported
# (in the environment, so that the ranks [ddp] spawns, which import this
# script anew, find the same files)
CLI_DIR = os.environ.setdefault("CHIP_SMOKE_CLI_DIR", os.path.join(
    tempfile.gettempdir(), f"chip_smoke_cli_{os.getpid()}"))
os.environ["REENACT_PRETRAINED_ROOT"] = os.path.join(CLI_DIR, "pretrained")
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
CLI_TARGETS, CLI_PATCH = 32, 128        # target PNGs; side of the textured patch
CLI_EDGE_TARGETS = (5, 21)              # targets whose patch sits on the top edge
CLI_WINDOW = 160                        # run (d)'s targets, in-frame PNGs repeated
CLI_MAX_DIFF = 1                        # run (a) vs the direct call, intensity units
HOST_CROP_FRAMES, HOST_CROP_REPS = 16, 5  # [cli]'s ffhq_crop_batch against the serial loop
GRAD_BATCH = 4                          # [grad]'s 256² frames needing a gradient
GRAD_RTOL, GRAD_ATOL = 1e-3, 2e-3       # card vs CPU gradients, atol relative to max
GRAD_FAN_DAMP = 0.3                     # [grad]'s FAN conv weights scaled against growth
FLAME_BATCH = 16
INVERT_IDS, INVERT_VIDEOS, INVERT_FRAMES, INVERT_BATCH = 2, 2, 8, 4
FLAME_RTOL, FLAME_ATOL = 1e-4, 1e-5     # FLAME decode card vs CPU, atol relative to max
# [render]: decode_deca at B = FLAME_BATCH, images 224², UV maps 256² over a
# torus of RENDER_TORUS segments (around its axis, around its tube): FLAME's
# 9976 faces, 5133 UV vertices (FLAME's head_template.obj has 5118); the
# card against the CPU on RENDER_CPU_FRAMES frames at the CPU tests' limits
# (tests/test_torch_render.py): rtol 1e-5, atol 1e-5·max, and at most
# RENDER_MAX_FLIPS of a map's pixels past them (coverage, the pos_mask
# threshold and winners flip on rounding); RENDER_REPS timed calls
RENDER_IMAGE, RENDER_UV, RENDER_TORUS = 224, 256, (86, 58)
RENDER_CPU_FRAMES, RENDER_REPS = 1, 3
RENDER_CHUNKS = (64, 128, 256, 512)       # faces a chunk, one UV rasterization at B = 16
RENDER_RTOL, RENDER_ATOL, RENDER_MAX_FLIPS = 1e-5, 1e-5, 0.005
# [train]: batch of (a), (b) and the timed steps; (a)'s steps; (b)'s tree
# (two pairs a video: 24 pairs, two steps an epoch); the timed steps
TRAIN_BATCH, TRAIN_STEPS = 12, 4
TRAIN_IDS, TRAIN_VIDEOS, TRAIN_FRAMES = 3, 4, 4
TRAIN_WARM, TRAIN_TIMED, TRAIN_PROFILED = 2, 5, 3
# (c): card vs CPU, one grads-only step: the loss terms' rtol; A's gradient
# rtol and atol relative to its max. The card's own gradient moves 4.8e-4
# to 1.6e-3 of its max under a 1e-6 change of A (the L1 losses' kinks and
# cuDNN's backward, the witness), and read 0.6e-3 to 2.1e-3 of max from
# the CPU's (read on an NVIDIA H100 80GB HBM3 at 700 W): no limit under the
# witness can hold. The witness is held under TRAIN_WITNESS_MAX, 0.6 of the
# atol (the disentanglement-50 step's read up to 2.1e-3); a control (the
# card's step with the synthesis in bf16 against the CPU's float32 step,
# read 7.8e-2) must read past the atol.
TRAIN_CPU_BATCH = 2
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-4, 1e-3, 5e-3
TRAIN_WITNESS_MAX = 0.6 * TRAIN_GRAD_ATOL
# (c)'s DECA head (last Linear) scale on both sides, as the CPU tests'
# (tests/torch_train_world.py): the random head regresses poses of several
# radians, where the card's own gradient moved 2.0e-3 of its max under a
# 1e-6 change of A (read on an H100), so no two float32 runs could agree
TRAIN_DECA_HEAD_SCALE = 0.1
IRSE_BN2_SCALE = 0.3                    # the seeded IR-SE-50's blocks, as e4e's


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


def tf32_rate(name):
    """Dense TF32 tensor-core FLOP/s of the card from the data sheets (495
    TFLOP/s on the H100 SXM and the H200), the rate K3's float32 path and
    the benchmark's ``k3_roofline`` are counted against."""
    if "H100" in name and "PCIe" in name:
        return 378e12
    if "H100" in name and "NVL" in name:
        return 418e12
    return 495e12


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


def k1_inputs(dtype, gen, batch=BATCH):
    """(call, input) for each K1 call of one synthesis of ``batch`` images
    (BATCH on the serving path, TRAIN_BATCH in a train step)."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import upfirdn2d_calls
    return [(c, torch.randn(c.shape, generator=gen, device=gen.device).to(dtype))
            for c in upfirdn2d_calls(SIZE, CM, batch)]


def k2_inputs(dtype, gen, with_mapping=False, batch=BATCH):
    """(shape, x, bias) for each K2 call of one synthesis of ``batch``
    images; ``with_mapping`` adds the mapping network's (batch, 512) and the
    mean latent's (4096, 512)."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import fused_bias_act_calls
    shapes = fused_bias_act_calls(SIZE, CM, batch)
    if with_mapping:
        shapes = shapes + [(batch, 512), (4096, 512)]
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
        inv = [1 + 0.1 * torch.randn(ci, generator=gen, device=gen.device) for ci, _ in cs]
        off = [0.1 * torch.randn(ci, generator=gen, device=gen.device) for ci, _ in cs]
        w = [torch.randn(co, ci, 3, 3, generator=gen, device=gen.device)
             * (2.0 / (9 * co)) ** 0.5 for ci, co in cs]
        x = torch.randn(shape, generator=gen, device=gen.device).to(dtype)
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
        for call, x in (c for b in (BATCH, TRAIN_BATCH) for c in k1_inputs(dtype, gen, b)):
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
        for shape, x, b in (c for n in (BATCH, TRAIN_BATCH)
                            for c in k2_inputs(dtype, gen, with_mapping=True, batch=n)):
            got = fused_bias_act_cuda(x, b)
            want = fused_leaky_relu_plain(x, b)
            torch.cuda.synchronize()
            err, lim = max_err(got, want), limit_for(want)
            print(f"[parity] fused_bias_act {shape} {str(dtype)[6:]}: max abs err "
                  f"{err:.3g} (limit {lim:.3g})")
            need(err <= lim, f"fused_bias_act {shape} {dtype} disagrees")
            if dtype == torch.float32:
                worst["fused_bias_act"] = max(worst["fused_bias_act"], err)
        k3_cases = [c for b in (BATCH, TRAIN_BATCH, 1) for c in k3_inputs(dtype, gen, b)]
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
        # K3: every call of the two FAN passes of a request. float32 runs
        # three TF32 products a product: its bound is the operations at the
        # TF32 rate (as the benchmark's k3_roofline counts them), its floor
        # three times that
        rate = tf32_rate(card_name) if dtype == torch.float32 else bf16_flops
        passes = 3 if dtype == torch.float32 else 1
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
                  f"(operations at {rate / 1e12:.0f} TFLOP/s"
                  + (f"; {passes}-product floor {passes * bound:.4f} ms" if passes > 1 else "")
                  + f"); kernel/composition {ms / plain:.3f}")
            add(t, ms=calls * ms, host_us=calls * host, call_ms=calls * call_ms,
                plain_ms=calls * plain, plain_call_ms=calls * plain_call,
                bound_ms=calls * bound, bytes=calls * nbytes, ops=calls * ops)
        out[("fused_conv_block", tag)] = t
        print(f"[timing] fused_conv_block per request of {BATCH} frames, {tag}: bound "
              f"{t['bound_ms']:.4f} ms at {rate / 1e12:.0f} TFLOP/s"
              + (f", {passes}-product floor {passes * t['bound_ms']:.4f} ms" if passes > 1
                 else "") + f", kernel device {t['ms']:.4f} ms")
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


def k1_bwd_inputs(dtype, gen, train=False):
    """(call, gradient of its output) for each K1 backward of one PTI step,
    or with ``train`` of one train step (every forward call of the shifted
    synthesis at TRAIN_BATCH: A shifts every layer's style)."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
        pti_backward_calls, upfirdn2d_calls)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import (
        upfirdn2d_output_shape)
    out = []
    calls = (upfirdn2d_calls(SIZE, CM, TRAIN_BATCH) if train
             else pti_backward_calls(SIZE, CM).upfirdn2d)
    for c in calls:
        oh, ow = upfirdn2d_output_shape(c.shape[2], c.shape[3], (4, 4), up=c.up, pad=c.pad)
        out.append((c, torch.randn(c.shape[:2] + (oh, ow), generator=gen,
                                   device="cuda").to(dtype)))
    return out


def k2_bwd_inputs(dtype, gen, train=False):
    """(shape, g, y) for each K2-bwd of one PTI step, or with ``train`` of
    one train step (every StyledConv of the shifted synthesis at
    TRAIN_BATCH); y is an activation output, negative on about half its
    elements."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
        fused_leaky_relu_plain)
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
        fused_bias_act_calls, pti_backward_calls)
    out = []
    shapes = (fused_bias_act_calls(SIZE, CM, TRAIN_BATCH) if train
              else pti_backward_calls(SIZE, CM).fused_bias_act)
    for s in shapes:
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
    one PTI step and of one train step, float32 and bf16."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
        fused_bias_act_bwd_cuda, fused_leaky_relu_bwd_plain)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import make_kernel
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
        upfirdn2d_backward, upfirdn2d_bwd_cuda)
    k = make_kernel((1, 3, 3, 1), gain=4)
    worst = {"upfirdn2d_bwd": 0.0, "fused_bias_act_bwd": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        for call, g in k1_bwd_inputs(dtype, gen) + k1_bwd_inputs(dtype, gen, train=True):
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
        for shape, g, y in k2_bwd_inputs(dtype, gen) + k2_bwd_inputs(dtype, gen, train=True):
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


def k3_leaves(x, args):
    """Leaf copies of x and the K3Args' folds and weights that need a
    gradient, and K3Args over them (the packed weights as they were: the
    kernel reads them, and their gradient would reach ``w``)."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_conv_block import K3Args
    leaves = [t.detach().clone().requires_grad_() for t in (x,) + args.inv + args.off + args.w]
    return leaves, K3Args(tuple(leaves[1:4]), tuple(leaves[4:7]), tuple(leaves[7:10]), args.wk)


def plain_grads(x, args, g):
    """Autograd through the plain composition from fresh leaves: the
    gradients of x and of every fold and weight."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_conv_block import (
        fused_conv_block_plain)
    leaves, largs = k3_leaves(x, args)
    return torch.autograd.grad(fused_conv_block_plain(leaves[0], largs), leaves, g)


def phase_k3_bwd(card_name):
    """K3's backward (``fused_conv_block_bwd``: the plain version recomputed
    and differentiated, through cuDNN) at the shapes of a FAN pass over
    GRAD_BATCH crops, float32 and bf16: the gradients of x and of every fold
    and weight through the autograd Function (the kernel forward, K3-bwd
    backward) against plain autograd through ``fused_conv_block_plain``; then
    its device time beside autograd through the cuDNN composition (its
    forward and backward: the same work), summed over the pass. Returns
    (worst float32 error, float32 timing sums)."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_conv_block import (
        fused_conv_block, fused_conv_block_bwd)
    bw, flops, bf16_flops = card_rates(card_name)
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst, timing = 0.0, None
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        rate = flops if dtype == torch.float32 else bf16_flops
        t = {"library_ms": None}
        for shape, n, x, args in k3_inputs(dtype, gen, GRAD_BATCH):
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            leaves, largs = k3_leaves(x, args)
            got = torch.autograd.grad(fused_conv_block(leaves[0], largs), leaves, g)
            want = plain_grads(x, args, g)
            torch.cuda.synchronize()
            tol = K3_F32_TOL if dtype == torch.float32 else BF16_TOL
            errs = [(max_err(a, b), tol * max(1.0, float(b.float().abs().max())))
                    for a, b in zip(got, want)]
            err = max(e for e, _ in errs)
            ratio = max(e / li for e, li in errs)
            print(f"[parity] fused_conv_block_bwd {shape} {tag}: gradients of x and the 9 "
                  f"folds and weights against plain autograd, max abs err {err:.3g}; worst "
                  f"err/limit {ratio:.3g} (limit {tol:g}·max(1, max|plain|) a tensor)")
            need(ratio <= 1.0,
                 f"fused_conv_block_bwd {shape} {dtype} disagrees with plain autograd")
            if dtype == torch.float32:
                worst = max(worst, err)
            needs = (True,) * 10
            weights = sum(w.numel() for w in args.w) + 2 * (256 + 128 + 64)
            nbytes = (3 * x.numel() + 2 * weights) * x.element_size()
            ops = 2 * K3_FLOP_PER_PIXEL * shape[0] * shape[2] * shape[3]
            bound = 1e3 * max(nbytes / bw, ops / rate)
            ms, host, call_ms = three_times(lambda: fused_conv_block_bwd(g, x, args, needs))
            plain, plain_host, plain_call = three_times(lambda: plain_grads(x, args, g))
            print(f"[timing] fused_conv_block_bwd {shape} {tag} x{n} a FAN pass: device "
                  f"{ms:.4f} ms, host {host:.2f} us, call {call_ms:.4f} ms; autograd through "
                  f"the cuDNN composition (forward and backward) device {plain:.4f} ms, host "
                  f"{plain_host:.2f} us, call {plain_call:.4f} ms; bound {bound:.4f} ms")
            add(t, ms=n * ms, host_us=n * host, call_ms=n * call_ms, plain_ms=n * plain,
                plain_call_ms=n * plain_call, bound_ms=n * bound, bytes=n * nbytes,
                ops=n * ops)
        print_sums(f"[timing] fused_conv_block_bwd per FAN pass over {GRAD_BATCH} crops, "
                   f"{tag} (plain = autograd's forward and backward through cuDNN)", t, bw)
        if dtype == torch.float32:
            timing = t
    return worst, timing


def grad_frames(n, seed):
    """n black 256² [0, 1] frames with a textured 96² patch each."""
    rs = np.random.RandomState(seed)
    f = np.zeros((n, 256, 256, 3), np.float32)
    for i in range(n):
        top, left = rs.randint(16, 144, 2)
        f[i, top:top + 96, left:left + 96] = rs.rand(96, 96, 3)
    return torch.from_numpy(f)


def grad_fan(damp):
    """[grad]'s FAN on the CPU: seeded, 4 modules, batch norms randomized,
    every convolution's weight scaled by ``damp``."""
    from stylegan_directions_face_reenactment_tpu_torch.weights import init_fan
    fan = init_fan(6, 4, device="cpu")
    randomize_bn(fan, 9)
    with torch.no_grad():
        for m in fan.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(damp)
    return fan


def phase_grad():
    """Images that need a gradient, on the card, through the DECA aligner
    and through FAN: (1) ``make_fan_align(fan, s3fd)`` on GRAD_BATCH 256²
    frames: one FAN pass (K3 56 times, forward only: detection, FAN and the
    landmarks are constants to autograd); the gradient of a fixed projection
    of the aligned crops against the CPU's gradient of ``landmark_align``
    with the card's landmarks (the warp alone carries it; an argmax that
    flips between devices cannot move it); no S3FD or FAN ``.grad``. (2)
    ``estimate_landmarks`` straight on the frames (FAN's crops are not
    stopped, as in the JAX package): the gradient of a projection of the
    heatmaps reaches the frames through K3's backward (56 K3, 56 K3-bwd),
    against the CPU's, with ``.backward()``: FAN's parameters get their
    ``.grad`` (through K3-bwd on the card; printed beside the CPU's) and
    S3FD's none. S3FD is gated on content as in the CLI phase; FAN's batch
    norms are randomized and its conv weights scaled by GRAD_FAN_DAMP
    (:func:`grad_witness` shows why)."""
    from stylegan_directions_face_reenactment_tpu_torch.models.face.landmarks import (
        estimate_landmarks)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline.alignment import (
        DECA_CROP, landmark_align, make_fan_align)
    from stylegan_directions_face_reenactment_tpu_torch.weights import init_s3fd
    sfd_cpu, fan_cpu = init_s3fd(5, device="cpu"), grad_fan(GRAD_FAN_DAMP)
    gate_s3fd_on_content(sfd_cpu)
    sfd, fan = copy.deepcopy(sfd_cpu).cuda(), copy.deepcopy(fan_cpu).cuda()
    frames = grad_frames(GRAD_BATCH, 60)
    rs = np.random.RandomState(61)
    proj = torch.from_numpy(rs.randn(GRAD_BATCH, DECA_CROP, DECA_CROP, 3).astype(np.float32))

    x = frames.cuda().detach().requires_grad_()
    torch.cuda.synchronize()
    reset_counts()
    aligned, ok = make_fan_align(fan, sfd, return_ok=True)(x)
    (aligned * proj.cuda()).sum().backward()
    torch.cuda.synchronize()
    got1 = read_all_counts()
    with torch.no_grad():
        lms, ok_lms, _ = estimate_landmarks(sfd, fan, frames.cuda() * 255.0, detector_input="fa")
    xc = frames.detach().clone().requires_grad_()
    (landmark_align(xc, lms.cpu(), ok_lms.cpu())[0] * proj).sum().backward()
    want, card = xc.grad, x.grad.cpu()
    ok_grad = allclose_scaled(card, want, GRAD_RTOL, GRAD_ATOL)
    print(f"[grad] (1) make_fan_align(fan, s3fd) on {GRAD_BATCH} 256² frames needing a "
          f"gradient: faces {int(ok.sum())} of {GRAD_BATCH}, ok mask as the card's landmark "
          f"pass: {bool(torch.equal(ok.cpu(), ok_lms.cpu()))}; d(projection)/d(frames) max "
          f"|card - CPU| {max_err(card, want):.3g} of max {float(want.abs().max()):.3g} "
          f"(rtol {GRAD_RTOL}, atol {GRAD_ATOL}·max: {ok_grad}); launches K3 {got1['K3']}, "
          f"K3-bwd {got1['K3-bwd']}")
    need(ok_grad and torch.equal(ok.cpu(), ok_lms.cpu()),
         "the card's aligner gradient disagrees with the CPU's")
    need(got1["K3"] == K3_PER_PASS and got1["K3-bwd"] == 0,
         f"make_fan_align launches {got1}, expected K3 {K3_PER_PASS} and no K3-bwd")
    need(all(p.grad is None for net in (sfd, fan) for p in net.parameters()),
         "an S3FD or FAN parameter got a gradient through the aligner")

    hproj = torch.from_numpy(rs.randn(GRAD_BATCH, 64, 64, 68).astype(np.float32))

    def heat_grad(sfd_, fan_, im):
        im = im.detach().clone().requires_grad_()
        heat = estimate_landmarks(sfd_, fan_, im * 255.0, detector_input="fa")[2]
        (heat * hproj.to(im.device)).sum().backward()
        return im.grad

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    card = heat_grad(sfd, fan, frames.cuda()).cpu()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got2 = read_all_counts()
    want = heat_grad(sfd_cpu, fan_cpu, frames)
    ok_grad = allclose_scaled(card, want, GRAD_RTOL, GRAD_ATOL)
    pairs = [(n, pc.grad, pg.grad) for (n, pc), pg in zip(fan_cpu.named_parameters(),
                                                          fan.parameters())]
    need(all(w is not None and g is not None for _, w, g in pairs),
         "a FAN parameter got no gradient through estimate_landmarks' crops")
    w_ratio, w_name = max((float(((g.cpu() - w).abs() / (GRAD_ATOL * float(w.abs().max())
                                                        + GRAD_RTOL * w.abs())).max()), n)
                          for n, w, g in pairs if float(w.abs().max()) > 0)
    print(f"[grad] (2) estimate_landmarks on the same frames: d(heatmap projection)/d(frames) "
          f"through FAN max |card - CPU| {max_err(card, want):.3g} of max "
          f"{float(want.abs().max()):.3g} (rtol {GRAD_RTOL}, atol {GRAD_ATOL}·max: {ok_grad}); "
          f"launches K3 {got2['K3']}, K3-bwd {got2['K3-bwd']}; {1e3 * wall:.1f} ms (first call)")
    print(f"[grad] (2) FAN's {len(pairs)} parameter gradients (.grad; K3-bwd on the card), not "
          f"held: worst |card - CPU| / (atol + rtol·|CPU|) of a tensor {w_ratio:.3g} ({w_name}; "
          f"K3-bwd's own gradients are held in [parity]); S3FD's none")
    need(ok_grad, "the card's FAN gradient disagrees with the CPU's")
    need(got2["K3"] == K3_PER_PASS and got2["K3-bwd"] == K3_PER_PASS,
         f"estimate_landmarks backward launches {got2}, expected K3 and K3-bwd {K3_PER_PASS}")
    need(all(p.grad is None for net in (sfd, sfd_cpu) for p in net.parameters()),
         "an S3FD parameter got a gradient through estimate_landmarks")
    grad_witness(frames, hproj, sfd_cpu)
    return {"K3": got1["K3"] + got2["K3"], "K3-bwd": got1["K3-bwd"] + got2["K3-bwd"]}


def grad_witness(frames, hproj, sfd_cpu):
    """Why [grad] scales FAN's convolutions: [grad] (2)'s gradient, d(heatmap
    projection)/d(frames) through ``estimate_landmarks``, undamped and at
    GRAD_FAN_DAMP, through four float32 paths against the CPU's float64
    (S3FD and FAN in float64, ``compute_dtype``): the card as served (K3
    forward, K3-bwd), the card with cuDNN's composition
    (``fused_conv_block_plain``) in place of the K3 forward (K3-bwd kept),
    the card's plain FAN (K3 off: cuDNN forward, autograd backward), and
    the CPU; and the card's paths against the CPU's float32, as [grad] (2)
    holds them. A ReLU input that rounds to the other side of 0 in one path
    moves that path's gradient of the random FAN by up to percents of its
    max; K3 is at fault only if its reading stands out. Prints the
    readings, holds none."""
    from stylegan_directions_face_reenactment_tpu_torch.models.face import fan as fan_mod
    from stylegan_directions_face_reenactment_tpu_torch.models.face.landmarks import (
        estimate_landmarks)
    from stylegan_directions_face_reenactment_tpu_torch.ops import fused_conv_block as k3
    sfd_card, sfd64 = copy.deepcopy(sfd_cpu).cuda(), copy.deepcopy(sfd_cpu).double()

    def heat_grad(sfd_, fan_, im, dtype=None):
        im = im.detach().clone().requires_grad_()
        heat = estimate_landmarks(sfd_, fan_, im * 255.0, compute_dtype=dtype,
                                  detector_input="fa")[2]
        (g,) = torch.autograd.grad((heat * hproj.to(heat.device)).sum(), im)
        return g.double().cpu()

    plain = lambda x, args: k3.fused_conv_block_plain(x, args)  # noqa: E731
    for damp in (1.0, GRAD_FAN_DAMP):
        fan_cpu = grad_fan(damp)
        fan_card = copy.deepcopy(fan_cpu).cuda()
        ref = heat_grad(sfd64, copy.deepcopy(fan_cpu).double(), frames.double(), torch.float64)
        cpu32 = heat_grad(sfd_cpu, fan_cpu, frames)
        got = {"card K3": heat_grad(sfd_card, fan_card, frames.cuda())}
        with mock.patch.object(k3, "fused_conv_block_cuda", plain):
            got["card cuDNN forward, K3-bwd"] = heat_grad(sfd_card, fan_card, frames.cuda())
        with mock.patch.object(fan_mod, "fused_convblock_enabled", lambda p, x: False):
            got["card plain FAN"] = heat_grad(sfd_card, fan_card, frames.cuda())
        scale, scale32 = float(ref.abs().max()), float(cpu32.abs().max())
        print(f"[grad] witness, FAN convs x{damp:g}, [grad] (2)'s frames: max |float32 path - "
              f"CPU float64| / max {scale:.3g}: "
              + ", ".join(f"{k} {float((v - ref).abs().max()) / scale:.3g}"
                          for k, v in list(got.items()) + [("CPU", cpu32)])
              + "; max |card path - CPU float32| / max: "
              + ", ".join(f"{k} {float((v - cpu32).abs().max()) / scale32:.3g}"
                          for k, v in got.items()))


def phase_flame():
    """FLAME decode (``deca_decode``) at B = FLAME_BATCH on the seeded DECA's
    synthetic FLAME (5023 vertices, 9976 faces): card against the CPU, float32,
    and its time (CUDA events, median of 20 calls after a warm-up)."""
    from stylegan_directions_face_reenactment_tpu_torch.models.deca import deca_decode
    from stylegan_directions_face_reenactment_tpu_torch.weights import init_deca
    deca_cpu = init_deca(2, device="cpu")
    deca = copy.deepcopy(deca_cpu).cuda()
    rs = np.random.RandomState(70)
    cd = {"shape": rs.randn(FLAME_BATCH, 100), "exp": rs.randn(FLAME_BATCH, 50),
          "pose": 0.3 * rs.randn(FLAME_BATCH, 6), "cam": 1 + np.abs(rs.randn(FLAME_BATCH, 3))}
    cd = {k: torch.from_numpy(v.astype(np.float32)) for k, v in cd.items()}
    cd_card = {k: v.cuda() for k, v in cd.items()}
    with torch.no_grad():
        got = [t.cpu() for t in deca_decode(deca, cd_card)]
        want = deca_decode(deca_cpu, cd)
        times = []
        for _ in range(21):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            deca_decode(deca, cd_card)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    ms = statistics.median(times[1:])
    ok = all(allclose_scaled(a, b, FLAME_RTOL, FLAME_ATOL) and a.shape == b.shape
             for a, b in zip(got, want))
    print(f"[flame] deca_decode at B = {FLAME_BATCH} on FLAME of "
          f"{deca.flame.v_template.shape[0]} vertices, {deca.flame.faces.shape[0]} faces: "
          f"landmarks2d {tuple(got[0].shape)}, landmarks3d {tuple(got[1].shape)}, vertices "
          f"{tuple(got[2].shape)}; max |card - CPU| "
          + ", ".join(f"{max_err(a, b):.3g}" for a, b in zip(got, want))
          + f" (rtol {FLAME_RTOL}, atol {FLAME_ATOL}·max: {ok}); {ms:.3f} ms a call "
          f"({min(times[1:]):.3f}-{max(times[1:]):.3f})")
    need(ok and all(bool(torch.isfinite(t).all()) for t in got),
         "FLAME decode on the card disagrees with the CPU")
    return ms


def smooth_fields(rs, shape, n, amp):
    """n fields over an (h, w) grid, each a product of one low sinusoid
    along each axis, (h, w, n) float32: seeded stand-ins for a face's
    textures and photos, which change slowly from pixel to pixel."""
    h, w = shape
    fx, fy = rs.uniform(0.5, 3.0, (2, n))
    px, py = rs.uniform(0, 2 * np.pi, (2, n))
    return (amp * np.sin(2 * np.pi * np.linspace(0, 1, h)[:, None] * fy + py)[:, None, :]
            * np.sin(2 * np.pi * np.linspace(0, 1, w)[:, None] * fx + px)[None, :, :]
            ).astype(np.float32)


def render_flips(got, want):
    """(entries past the [render] limits, entries): pixels of an NHWC map,
    else elements."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    bad = (got - want).abs() > RENDER_ATOL * want.abs().max() + RENDER_RTOL * want.abs()
    if bad.dim() == 4:
        bad = bad.any(-1)
    return int(bad.sum()), bad.numel()


def torus_flame(rs, n_verts, n_faces, n_u=RENDER_TORUS[0], n_v=RENDER_TORUS[1]):
    """FLAME arrays over a torus at FLAME's sizes, and its UV atlas.

    The torus (major radius 50, tube 20, n_u segments around the axis, n_v
    around the tube: n_u·n_v vertices, 2·n_u·n_v faces wound outward; the
    rest of the ``n_verts`` vertices sit at its centre, on no face) is a
    closed smooth surface, as a head is: its vertex normals are sums of
    like-facing face normals, and its detail maps change slowly from texel
    to texel (texels 0.5-1.4 apart beside displacements of at most 0.01).
    Its atlas is the (u, v) grid split at both seams, (n_u + 1)·(n_v + 1)
    UV vertices whose triangles tile [0.05, 0.95]² without overlapping (at
    the UV rasterization's single depth, overlapping UV triangles would
    tie and the rounding of their barycentric sums would pick the
    winner); the tube's seam lies on its far side. Shape and pose blend
    shapes × 1e-3; skinning on the global joint alone (rigid); landmarks on
    random faces."""
    assert 2 * n_u * n_v == n_faces and n_u * n_v <= n_verts
    u = 2 * np.pi * np.arange(n_u) / n_u                          # around the axis z
    v = 2 * np.pi * np.arange(n_v)[:, None] / n_v                 # around the tube
    ring = 50.0 + 20.0 * np.sin(v) + 0 * u                        # (n_v, n_u)
    pts = np.zeros((n_verts, 3), np.float32)
    pts[:n_u * n_v] = np.stack([ring * np.cos(u), ring * np.sin(u), -20.0 * np.cos(v) + 0 * u],
                               -1).reshape(-1, 3)
    faces, uvfaces = [], []
    for i in range(n_v):
        for j in range(n_u):
            a, b = i * n_u + j, i * n_u + (j + 1) % n_u
            c, d = (i + 1) % n_v * n_u + j, (i + 1) % n_v * n_u + (j + 1) % n_u
            ua, ub = i * (n_u + 1) + j, i * (n_u + 1) + j + 1
            faces += [[a, b, c], [b, d, c]]
            uvfaces += [[ua, ub, ua + n_u + 1], [ub, ub + n_u + 1, ua + n_u + 1]]
    faces, uvfaces = np.asarray(faces, np.int64), np.asarray(uvfaces, np.int64)
    fv = pts[faces].astype(np.float64)
    mid = fv.mean(1)
    core = 50.0 * mid * [1, 1, 0] / np.linalg.norm(mid[:, :2], axis=1, keepdims=True)
    if (np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]) * (mid - core)).sum() < 0:
        faces, uvfaces = faces[:, ::-1].copy(), uvfaces[:, ::-1].copy()
    grid = np.array([[j / n_u, i / n_v] for i in range(n_v + 1) for j in range(n_u + 1)])

    def simplex(*shape):
        e = np.exp(rs.randn(*shape))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    lbs_weights = np.zeros((n_verts, 5), np.float32)
    lbs_weights[:, 0] = 1.0
    params = {"v_template": pts, "shapedirs": (1e-3 * rs.randn(n_verts, 3, 150)).astype(np.float32),
              "posedirs": (1e-3 * rs.randn(36, n_verts * 3)).astype(np.float32),
              "j_regressor": simplex(5, n_verts), "lbs_weights": lbs_weights, "faces": faces,
              "lmk_faces_idx": rs.randint(0, n_faces, 51), "lmk_bary_coords": simplex(51, 3),
              "dynamic_lmk_faces_idx": rs.randint(0, n_faces, (79, 17)),
              "dynamic_lmk_bary_coords": simplex(79, 17, 3),
              "full_lmk_faces_idx": rs.randint(0, n_faces, 68), "full_lmk_bary_coords": simplex(68, 3)}
    return params, (0.05 + 0.9 * grid).astype(np.float32), uvfaces


def phase_render(smi):
    """[render]: the DECA renderer group at FLAME's full size on the card.
    The seeded DECA with its detail branch, its FLAME arrays over a torus
    of FLAME's 5023 vertices and 9976 faces with a seam-split atlas
    (:func:`torus_flame`: a smooth closed surface whose UV triangles do not
    overlap, so that card and CPU differ only by rounding, at pixels on an
    edge or a seam), a texture space of the real width (mean 512²·3, 50
    components, smooth seeded fields), UV maps of 256² (the dense
    triangulation of 122,990 faces). ``deca_encode(with_detail=True)`` on 16
    smooth seeded 224² images, then pose and camera set to seeded values
    that keep the torus in frame (the random encoder's put it anywhere);
    ``decode_deca(use_tex=True, draw_landmarks=False)`` timed (CUDA events,
    median of RENDER_REPS after a warm-up), its peak memory, its launches a
    call (torch.profiler) and the rasterizer's chunk; one UV rasterization
    of the batch at each chunk of RENDER_CHUNKS, which must give the same
    result; ``shape_visualization`` at B = 16; then every opdict and
    visdict entry of the first RENDER_CPU_FRAMES frames card against CPU."""
    from stylegan_directions_face_reenactment_tpu_torch.models.deca import (
        deca_encode, decode_deca, shape_visualization)
    from stylegan_directions_face_reenactment_tpu_torch.models.deca.flame import FLAME, FLAMETex
    from stylegan_directions_face_reenactment_tpu_torch.models.deca.render import (
        _assets as make_assets, process_uvcoords, raster_chunk, rasterize)
    from stylegan_directions_face_reenactment_tpu_torch.weights import init_deca
    t_phase = time.perf_counter()
    b, size, uv = FLAME_BATCH, RENDER_IMAGE, RENDER_UV
    rs = np.random.RandomState(80)
    deca_cpu = init_deca(2, device="cpu", with_detail=True)
    n_verts, n_faces = deca_cpu.flame.v_template.shape[0], deca_cpu.flame.faces.shape[0]
    params, uvcoords, uvfaces = torus_flame(rs, n_verts, n_faces)
    deca_cpu.flame = FLAME(params)
    deca_cpu.flametex = FLAMETex(
        (0.5 + smooth_fields(rs, (512, 512), 3, 0.2)).reshape(1, -1),
        smooth_fields(rs, (512, 512), 150, 0.01).reshape(512, 512, 3, 50).reshape(-1, 50))
    deca = copy.deepcopy(deca_cpu).cuda()
    assets_cpu = make_assets(uvcoords, uvfaces, np.ones((uv, uv, 1), np.float32),
                             np.zeros((uv, uv), np.float32), uv, None)
    assets = {k: v.cuda() for k, v in assets_cpu.items()}
    images = torch.from_numpy(np.stack([0.5 + smooth_fields(rs, (size, size), 3, 0.4)
                                        for _ in range(b)])).cuda()
    pose = torch.from_numpy((0.3 * rs.randn(b, 6)).astype(np.float32)).cuda()
    cam = torch.from_numpy(np.stack([0.012 * (1 + 0.03 * rs.randn(b)), 2 * rs.randn(b),
                                     2 * rs.randn(b)], 1).astype(np.float32)).cuda()
    with torch.no_grad():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        deca_encode(deca, images, with_detail=True)
        start.record()
        cd = deca_encode(deca, images, with_detail=True)
        end.record()
        torch.cuda.synchronize()
        encode_ms = start.elapsed_time(end)
        need(cd["detail"].shape == (b, 128) and bool(torch.isfinite(cd["detail"]).all()),
             f"deca_encode(with_detail=True) gave detail {tuple(cd['detail'].shape)}")
        cd.update(pose=pose, cam=cam, images=images)

        def run():
            return decode_deca(deca, cd, assets, image_size=size, uv_size=uv, use_tex=True,
                               draw_landmarks=False)

        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for _ in range(RENDER_REPS):
            start.record()
            op, vis = run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
        launches, busy_us, wall_us = profile_request("[render]", "decode_deca at B = 16", run)
        start.record()
        sv = shape_visualization(deca, cd, images=images, image_size=size)
        end.record()
        torch.cuda.synchronize()
        sv_ms = start.elapsed_time(end)
        need(sv.shape == (b, size, size, 3) and bool(torch.isfinite(sv).all())
             and float((sv - images).abs().max()) > 0.1,
             "shape_visualization on the card rendered nothing over the images")
        for d in (op, vis):
            for k, v in d.items():
                need(bool(torch.isfinite(v).all()), f"decode_deca's {k} is not finite")
        need(op["uv_detail_normals"].shape == (b, uv, uv, 3)
             and vis["shape_images"].shape == (b, size, size, 3)
             and float(vis["shape_images"].max()) > 0.1,
             "decode_deca's shapes or shape render are off")

        # one UV rasterization of the batch at each chunk: the card's default
        # (the JAX package's 256) against its neighbours, and the same result
        # at every chunk
        uvc = process_uvcoords(assets["uvcoords"])
        fv, uv_pos = op["vertices"][:, deca.flame.faces], uvc[None].expand((b,) + uvc.shape)
        sweep, outs = {}, []
        for c in RENDER_CHUNKS:
            start.record()
            outs.append(rasterize(uv_pos, assets["uvfaces"], fv, uv, c))
            end.record()
            torch.cuda.synchronize()
            sweep[c] = start.elapsed_time(end)
        need(all(torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1])
                 for o in outs[1:]), "the rasterizer's result changed with its chunk")
        del outs, fv, uv_pos
        card_s = time.perf_counter() - t_phase
        n = RENDER_CPU_FRAMES
        t0 = time.perf_counter()
        op_c, vis_c = decode_deca(deca_cpu, {k: v[:n].cpu() for k, v in cd.items()}, assets_cpu,
                                  image_size=size, uv_size=uv, use_tex=True, draw_landmarks=False)
        cpu_s = time.perf_counter() - t0
    report, ok = [], True
    for tag, got_d, want_d in (("op", op, op_c), ("vis", vis, vis_c)):
        need(set(got_d) == set(want_d), f"[render] {tag} keys differ")
        for k in sorted(want_d):
            bad, total = render_flips(got_d[k][:n], want_d[k])
            ok &= bad <= (RENDER_MAX_FLIPS * total if want_d[k].dim() == 4 else 0)
            report.append(f"{k} {max_err(got_d[k][:n].float().cpu(), want_d[k]):.3g} "
                          f"({bad}/{total})")
    ms = statistics.median(times)
    print(f"[render] card vs CPU on {n} frames, max |card - CPU| (entries past rtol "
          f"{RENDER_RTOL}, atol {RENDER_ATOL}·max / entries): " + ", ".join(report)
          + f"; set-up and the card {card_s:.1f} s, the CPU's decode {cpu_s:.1f} s on "
          f"{torch.get_num_threads()} threads")
    need(ok, f"[render] card disagrees with the CPU past the limits (at most "
             f"{RENDER_MAX_FLIPS} of a map's pixels, no other entry)")
    chunks = (raster_chunk(b, size), raster_chunk(b, uv))
    print(f"[result] [render] decode_deca at B = {b} (image {size}, UV {uv}, {n_faces} faces, "
          f"{len(uvcoords)} UV vertices, use_tex): {ms:.3f} ms a call (median of "
          f"{RENDER_REPS}, {min(times):.3f}-{max(times):.3f}), peak {peak} bytes "
          f"({peak - base} above the inputs), {launches} kernel launches a call (device busy "
          f"{busy_us / 1e3:.3f} of {wall_us / 1e3:.3f} ms under the profiler), rasterizer "
          f"chunk {chunks[0]} faces at {size}², {chunks[1]} at {uv}² (one UV rasterization "
          f"of the batch: " + ", ".join(f"chunk {c} {t:.3f} ms" for c, t in sweep.items())
          + f"); deca_encode with "
          f"detail {encode_ms:.3f} ms; shape_visualization {sv_ms:.3f} ms; phase "
          f"{time.perf_counter() - t_phase:.1f} s on {smi}")
    return ms


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
    return n_kernels, busy, wall_us


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


def k3_bwd():
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_conv_block import (
        fused_conv_block_bwd)
    return fused_conv_block_bwd


def reset_counts():
    for k in counts() + bwd_counts() + (k3_bwd(),):
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
        box_to_center_scale, crop_faces, crop_transform, detect_faces, fan_forward,
        ffhq_crop_device, heatmaps_to_landmarks, landmarks_to_image_coords, s3fd_forward,
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
        affine = crop_transform(center, scale)
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
        affine_cpu = crop_transform(center.cpu(), scale.cpu())
        affine_err = float(((affine.cpu() - affine_cpu).abs()
                            / affine_cpu.abs().clamp_min(1e-30)).max())
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
    print(f"[slice2] crop_transform of request 1's {fr0.shape[0]} FAN crops on the card "
          f"({affine.device}, {tuple(affine.shape)}) against the CPU: max relative diff "
          f"{affine_err:.3g} (limit 1e-6)")
    need(affine.is_cuda and tuple(affine.shape) == (fr0.shape[0], 3, 3) and affine_err <= 1e-6,
         "crop_transform on the card disagrees with the CPU")
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


def gate_s3fd_on_content(sfd):
    """S3FD's stride-4 face logit := the sum of the L2-normed conv3_3
    features in its 3x3 window less 10. Every trunk bias of the seeded S3FD
    is 0, so where the frame is black the score is about 5e-5 and near
    content 1.0: the face the reference keeps lies on the frame's textured
    patch. (With a head's bias boosted, every anchor scores 1.0 and the kept
    face lies on the frame's top edge, whose FFHQ box always leaves the
    frame.)"""
    conv = sfd.conv3_3_norm_mbox_conf
    with torch.no_grad():
        conv.weight.zero_()
        conv.bias.zero_()
        conv.weight[3] = 1.0
        conv.bias[3] = -10.0


def randomize_bn(module, seed):
    """Random batch-norm statistics and affine terms (scale 1 ± 0.1, var
    0.5-1.5). At identity statistics the seeded 4-module FAN's 68 heatmaps
    peak at one cell, and the landmarks' box has no size."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy((1 + 0.1 * rs.randn(c)).astype(np.float32)))
                m.bias.copy_(torch.from_numpy((0.1 * rs.randn(c)).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy((0.1 * rs.randn(c)).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy((0.5 + rs.rand(c)).astype(np.float32)))


def patch_frame(top, left, seed):
    """A black 562x1000 uint8 frame with a CLI_PATCH² patch of uniform noise
    at (top, left)."""
    f = np.zeros(FRAME_HW + (3,), np.uint8)
    f[top:top + CLI_PATCH, left:left + CLI_PATCH] = np.random.RandomState(seed).randint(
        0, 256, (CLI_PATCH, CLI_PATCH, 3))
    return f


def write_cli_inputs():
    """The seeded nets of slice 3 as checkpoint files in the reference's
    layouts (the generator's ``g_ema`` without its noise buffers and with the
    modulated-conv weights' leading axis of 1, e4e's ``e``, the A bundle,
    DECA's ``E_flame``, S3FD's raw state dict, ``{"state_dict": FAN}``, the
    LPIPS bundle) and the PNG inputs. S3FD is gated on content and FAN's
    batch norms are randomized. Returns (source path, target folder)."""
    from PIL import Image

    from stylegan_directions_face_reenactment_tpu_torch.configs import AUX_MODELS, MODELS
    from stylegan_directions_face_reenactment_tpu_torch.weights import write_flame_files
    g, a, deca, sfd, fan, e4e, lp = build_slice3_nets("cpu")
    gate_s3fd_on_content(sfd)
    randomize_bn(fan, 9)
    row = MODELS["voxceleb"]
    os.makedirs(os.path.dirname(row["generator_path"]), exist_ok=True)
    torch.save({"g_ema": {k: (v[None] if k.endswith("conv.weight") else v)
                          for k, v in g.state_dict().items() if not k.startswith("noises.")}},
               row["generator_path"])
    torch.save({"e": e4e.state_dict()}, row["e4e_path"])
    torch.save({"A_matrix": a.state_dict(), "w_plus": True, "num_layers_shift": 8},
               row["directions_path"])
    torch.save({"E_flame": deca.E_flame.state_dict()}, AUX_MODELS["deca"])
    torch.save(sfd.state_dict(), AUX_MODELS["sfd"])
    torch.save({"state_dict": fan.state_dict()}, AUX_MODELS["fan_2d"])
    torch.save({"alex_features": lp.net.layers.state_dict(), "lin": lp.lin.state_dict()},
               AUX_MODELS["lpips_alex"])
    write_flame_files(AUX_MODELS["flame"], AUX_MODELS["flame_landmarks"])

    # the face lands about 30 px above the patch and its FFHQ box is about
    # 64 px: patches from 120 px below the top edge keep it in the frame
    h, w = FRAME_HW
    source = os.path.join(CLI_DIR, "source.png")
    Image.fromarray(patch_frame((h - CLI_PATCH) // 2, (w - CLI_PATCH) // 2, 40)).save(source)
    targets = os.path.join(CLI_DIR, "targets")
    os.makedirs(targets)
    rs = np.random.RandomState(41)
    for i in range(CLI_TARGETS):
        top = 0 if i in CLI_EDGE_TARGETS else int(rs.randint(120, h - CLI_PATCH - 30))
        left = int(rs.randint(100, w - CLI_PATCH - 100))
        Image.fromarray(patch_frame(top, left, 50 + i)).save(
            os.path.join(targets, f"{i:03d}.png"))
    return source, targets


def read_all_counts():
    """(K1, K1 backward, of which down 2, K2, K2-bwd, K3, K3-bwd) launches."""
    fwd, bwd = read_counts(), read_bwd_counts()
    return {"K1": fwd[0], "K1-bwd": bwd[0], "K1-bwd down 2": bwd[1], "K2": fwd[1],
            "K2-bwd": bwd[2], "K3": fwd[2], "K3-bwd": k3_bwd().launches}


def phase_cli(smi):
    """``cli/run_inference.py::main`` on the card, four runs."""
    from PIL import Image

    from stylegan_directions_face_reenactment_tpu_torch.cli import model_loading
    from stylegan_directions_face_reenactment_tpu_torch.cli import run_inference as cli
    from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
    from stylegan_directions_face_reenactment_tpu_torch.native import (
        extract_frames)
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
        fused_bias_act_calls, pti_backward_calls, upfirdn2d_calls)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import make_fused_reenact_fn

    t0 = time.perf_counter()
    source, targets = write_cli_inputs()
    print(f"[cli] checkpoint files and {CLI_TARGETS + 1} PNGs of {FRAME_HW[0]}x{FRAME_HW[1]} "
          f"written to {CLI_DIR} in {time.perf_counter() - t0:.1f} s")
    window = os.path.join(CLI_DIR, "window")
    os.makedirs(window)
    in_frame = [f for i, f in enumerate(sorted(os.listdir(targets)))
                if i not in CLI_EDGE_TARGETS]
    for i in range(CLI_WINDOW):
        os.symlink(os.path.join(targets, in_frame[i % len(in_frame)]),
                   os.path.join(window, f"{i:03d}.png"))

    pti = pti_backward_calls(SIZE, CM)
    k1, k2 = len(upfirdn2d_calls(SIZE, CM, 1)), len(fused_bias_act_calls(SIZE, CM, 1))
    k1b_down2 = sum(c.up == 2 for c in pti.upfirdn2d)
    n_mlp = MODELS["voxceleb"]["n_mlp"]

    def expected(pti_steps, k3_chunk, fallback_calls, n_frames):
        """Launches of one run: the mean latent's mapping (K2 a layer), the
        source's FAN pass and its DECA alignment (K3 56 each), the PTI
        steps, the chunks and the fallback calls (an unfused reenactment of
        a padded chunk with the SFD + FAN alignment)."""
        chunks = -(-n_frames // BATCH)
        calls = chunks + fallback_calls
        return {"K1": pti_steps * k1 + calls * k1, "K1-bwd": pti_steps * len(pti.upfirdn2d),
                "K1-bwd down 2": pti_steps * k1b_down2,
                "K2": n_mlp + pti_steps * k2 + calls * k2,
                "K2-bwd": pti_steps * len(pti.fused_bias_act),
                "K3": 2 * K3_PER_PASS + chunks * k3_chunk + fallback_calls * K3_PER_PASS,
                "K3-bwd": 0}

    kept = {}
    real_setup = cli.setup_source

    def kept_setup(*args, **kwargs):
        out = real_setup(*args, **kwargs)
        kept["args"], kept["kwargs"], kept["out"] = args, kwargs, out
        return out

    # tag: (flags, PTI steps, K3 launches a chunk, targets)
    runs = {"a": (["--save_video", "--save_images", "--save_grid"], PTI_STEPS, K3_PER_REQUEST,
                  targets),
            "b": (["--compute_dtype", "bfloat16", "--reuse_landmarks", "--video_content",
                   "reenact", "--no-optimize_generator", "--no-save_video", "--save_images"],
                  0, K3_PER_PASS, targets),
            "c": (["--no-device_crop", "--no-save_video", "--save_images", "--save_grid"],
                  PTI_STEPS, 2 * K3_PER_PASS, targets),
            "d": (["--no-optimize_generator", "--no-save_video", "--save_images", "--save_grid"],
                  0, K3_PER_REQUEST, window)}
    totals, results = Counter(), {}
    cli.setup_source = kept_setup
    try:
        for tag, (flags, steps, k3_chunk, folder) in runs.items():
            out = os.path.join(CLI_DIR, f"out_{tag}")
            n_frames = len(os.listdir(folder))
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            stats = cli.main(["--source_path", source, "--target_path", folder,
                              "--output_path", out, "--frame_batch", str(BATCH)] + flags)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_all_counts()
            want = expected(steps, k3_chunk, stats.get("fallback_calls", 0), n_frames)
            fps = stats["frames"] / stats["target_s"]
            results[tag] = {"wall_s": wall, "target_fps": fps, **stats}
            print(f"[cli] run ({tag}) {' '.join(flags)}: wall {wall:.3f} s, target loop "
                  f"{stats['target_s']:.3f} s = {fps:.2f} frames/s over {stats['frames']} "
                  f"frames ({'fused' if stats['fused'] else 'unfused'} loop; host clock, "
                  f"synchronized) on {smi}; frames without a face {stats.get('no_face', 0)}, "
                  f"frames that took the host-crop fallback {stats.get('fallback_frames', 0)} "
                  f"in {stats.get('fallback_calls', 0)} call(s)")
            print(f"[cli] run ({tag}) target loop by part (host clock, s): "
                  + ", ".join(f"{k[:-2]} {v:.3f}" for k, v in stats.items()
                              if k.endswith("_s") and k not in ("target_s", "video_s")))
            print(f"[cli] run ({tag}) launches: "
                  + ", ".join(f"{k} {got[k]} (expected {want[k]})" for k in got))
            need(got == want, f"CLI run ({tag}): launches {got}, expected {want}")
            totals.update(got)

            files = sorted(os.listdir(out))
            pngs = [f"{i:06d}.png" for i in range(n_frames)]
            need(all(f in files for f in pngs), f"CLI run ({tag}): per-frame PNGs missing")
            if "--save_grid" in flags:
                grids = sorted(os.listdir(os.path.join(out, "grids")))
                need(grids == pngs, f"CLI run ({tag}): grids/ holds {len(grids)} files")
                cell = np.asarray(Image.open(os.path.join(out, "grids", pngs[0])))
                need(cell.shape == (256, 3 * 256, 3), f"CLI run ({tag}): grid {cell.shape}")
            if "--save_video" in flags:
                video = extract_frames(os.path.join(out, "generated_video.mp4"))
                print(f"[cli] run ({tag}) video through OpenCV (mp4v): written in "
                      f"{stats['video_s']:.3f} s (host clock, after the target loop), "
                      f"{len(video)} frames of {video[0].shape} read back")
                need(len(video) in (n_frames, n_frames + 1) and video[0].shape == (256, 768, 3),
                     f"CLI run ({tag}): the video holds {len(video)} frames")
            first = np.asarray(Image.open(os.path.join(out, pngs[0])))
            need(first.shape == (SIZE, SIZE, 3), f"CLI run ({tag}): frame {first.shape}")
            print(f"[cli] run ({tag}) wrote {len(files)} entries: {n_frames} frames "
                  f"{first.shape}" + (", grids/" if "--save_grid" in flags else "")
                  + (", generated_video.mp4" if "--save_video" in flags else ""))
            if tag == "a":
                setup_a = (kept["args"], kept["kwargs"], kept["out"])
            need(stats["fused"] == (tag != "c"), f"CLI run ({tag}) took the wrong loop")
    finally:
        cli.setup_source = real_setup
    need(results["a"]["fallback_frames"] > 0, "no frame took the host-crop fallback")
    host_crop(targets, in_frame[:HOST_CROP_FRAMES])

    # run (a)'s first chunk against the fused program called directly on the
    # same frames with the set-up's outputs
    (g, _, deca, _, _), kw, (_, code, g_src, p_src, ang_src) = setup_a
    a = model_loading.load_direction_matrix()
    fan, sfd = kw["fan_params"], kw["s3fd_params"]
    fn = make_fused_reenact_fn(g_src, a, deca, initialize_directions("voxceleb", 15, 6.0),
                               sfd, fan, truncation=0.7,
                               truncation_latent=kw["truncation_latent"], fan_params=fan,
                               s3fd_params=sfd, outputs="reenact")
    names = sorted(os.listdir(targets))[:BATCH]
    frames = np.stack([np.asarray(Image.open(os.path.join(targets, f))) for f in names])
    reen, ok, in_frame, _ = (t.cpu().numpy() for t in fn(code, p_src, ang_src, frames))
    same = np.nonzero(ok & in_frame)[0]
    need(len(same) >= len(names) // 2, f"only {len(same)} of chunk 0's frames are in the frame")
    diffs = [int(np.abs(np.asarray(Image.open(os.path.join(CLI_DIR, "out_a", f"{i:06d}.png")))
                        .astype(int) - reen[i].astype(int)).max()) for i in same]
    print(f"[cli] run (a), chunk 0: {len(same)} of {len(names)} frames in the frame; their PNGs "
          f"against a direct make_fused_reenact_fn(outputs='reenact') call: max |diff| "
          f"{max(diffs)} intensity units (limit {CLI_MAX_DIFF})")
    need(max(diffs) <= CLI_MAX_DIFF, "the CLI's frames disagree with the direct call")
    return results, totals


def host_crop(folder, names):
    """``native/imgproc.py::ffhq_crop_batch`` against the serial
    ``crop_using_landmarks`` loop on the CLI's in-frame PNGs, with landmarks
    planted on a ring inside each frame: the same bytes, and each one's
    median host ms of HOST_CROP_REPS calls."""
    from PIL import Image

    from stylegan_directions_face_reenactment_tpu_torch.models.face.cropping import (
        crop_using_landmarks)
    from stylegan_directions_face_reenactment_tpu_torch.native.imgproc import ffhq_crop_batch
    frames = np.stack([np.asarray(Image.open(os.path.join(folder, f))) for f in names])
    rs = np.random.RandomState(43)
    t = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    pts = []
    for _ in names:
        cx, cy, r = rs.uniform(250, 750), rs.uniform(250, 320), rs.uniform(50, 100)
        k = rs.uniform(0.6, 1.0, (2, 68))
        pts.append(np.stack([cx + r * np.cos(t) * k[0], cy + r * np.sin(t) * k[1]], -1))
    pts = np.float32(pts)

    def batch():
        return ffhq_crop_batch(frames, pts)

    def serial():
        return np.stack([crop_using_landmarks(f, p) for f, p in zip(frames, pts)])

    ms = {}
    for tag, fn in (("batch", batch), ("serial", serial)):
        fn()
        runs = []
        for _ in range(HOST_CROP_REPS):
            t0 = time.perf_counter()
            out = fn()
            runs.append((time.perf_counter() - t0) * 1e3)
        ms[tag] = (statistics.median(runs), min(runs), max(runs))
        if tag == "batch":
            crops, done = out
        else:
            want = out
    diff = np.abs(crops.astype(int) - want.astype(int))
    print(f"[cli] host crop: ffhq_crop_batch on {len(names)} in-frame frames of "
          f"{frames.shape[1]}x{frames.shape[2]} "
          f"{ms['batch'][0]:.3f} ms (min {ms['batch'][1]:.3f}, max {ms['batch'][2]:.3f}), "
          f"the serial crop_using_landmarks loop {ms['serial'][0]:.3f} ms (min "
          f"{ms['serial'][1]:.3f}, max {ms['serial'][2]:.3f}); median of {HOST_CROP_REPS} "
          f"calls, host clock, {os.cpu_count()} host cores, torch {torch.get_num_threads()} "
          f"intra-op threads; max |diff| {int(diff.max())} (limit 0), {int((diff > 0).sum())} "
          f"of {diff.size} bytes differ")
    need(bool(done.all()) and int(diff.max()) == 0,
         "ffhq_crop_batch disagrees with the serial crop")
    return ms


def phase_edit(smi):
    """``cli/run_facial_editing.py::main`` on the card at full width, on the
    CLI phase's checkpoint files (and its FLAME files), directions 0 3 4
    (yaw, jaw, the first expression) at the default 10 shifts a side: (a)
    the 562x1000 source PNG (SFD → FAN → FFHQ crop, e4e, 200 PTI steps, the
    source's ``fan`` DECA alignment) with ``--optimize_generator
    --save_gif``; (b) a ``.npy`` W+ code; (c) a random z. Each run's launches
    of every kernel against what its source and sweeps should launch, the
    file layout, and run (a)'s first sweep against a direct
    ``sweep_direction`` call; then the images/s of one direct sweep."""
    from PIL import Image

    from stylegan_directions_face_reenactment_tpu_torch.cli import model_loading
    from stylegan_directions_face_reenactment_tpu_torch.cli import run_facial_editing as cli
    from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
        fused_bias_act_calls, pti_backward_calls, upfirdn2d_calls)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import sweep_direction

    source = os.path.join(CLI_DIR, "source.png")
    code = os.path.join(CLI_DIR, "code.npy")
    np.save(code, (0.5 * np.random.RandomState(80).randn(14, 512)).astype(np.float32))
    pti = pti_backward_calls(SIZE, CM)
    k1, k2 = len(upfirdn2d_calls(SIZE, CM, 1)), len(fused_bias_act_calls(SIZE, CM, 1))
    n_mlp = MODELS["voxceleb"]["n_mlp"]
    directions = ["0", "3", "4"]

    def expected(pti_steps, kind):
        """The mean latent's mapping (K2 a layer), a random z's mapping, the
        synthesis of a code or z source, the PTI steps, an image source's
        FAN pass and the source's DECA alignment (K3 56 each), one
        synthesis a sweep."""
        synth = len(directions) + (kind != "image")
        return {"K1": pti_steps * k1 + synth * k1,
                "K1-bwd": pti_steps * len(pti.upfirdn2d),
                "K1-bwd down 2": pti_steps * sum(c.up == 2 for c in pti.upfirdn2d),
                "K2": n_mlp * (1 + (kind == "z")) + pti_steps * k2 + synth * k2,
                "K2-bwd": pti_steps * len(pti.fused_bias_act),
                "K3": K3_PER_PASS * (1 + (kind == "image")), "K3-bwd": 0}

    runs = {"a": (["--source_path", source, "--optimize_generator", "--save_gif"], "image",
                  PTI_STEPS),
            "b": (["--source_path", code], "npy", 0),
            "c": (["--seed", "5"], "z", 0)}
    totals, results = Counter(), {}
    for tag, (flags, source_kind, steps) in runs.items():
        out = os.path.join(CLI_DIR, f"edit_{tag}")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = cli.main(["--output_path", out, "--directions", *directions] + flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_all_counts()
        want = expected(steps, source_kind)
        n_img = sum(len(v) for v in res["sweeps"].values())
        print(f"[edit] run ({tag}) {source_kind} source {' '.join(flags[2:])}: wall {wall:.3f} s "
              f"(host clock, synchronized) for {n_img} images in {len(res['sweeps'])} sweeps "
              f"({', '.join(f'{k} {len(v)}' for k, v in res['sweeps'].items())}) on {smi}")
        print(f"[edit] run ({tag}) launches: "
              + ", ".join(f"{k} {got[k]} (expected {want[k]})" for k in got))
        need(got == want, f"editing run ({tag}): launches {got}, expected {want}")
        totals.update(got)
        names = sorted(res["sweeps"])
        need(names == ["exp_00", "jaw", "yaw"], f"editing run ({tag}): sweeps {names}")
        for name, values in res["sweeps"].items():
            files = sorted(os.listdir(os.path.join(out, name)))
            need(files == [f"{name}_{i:03d}.png" for i in range(len(values))],
                 f"editing run ({tag}): {name}/ holds {files[:3]}...")
        gifs = sorted(f for f in os.listdir(out) if f.endswith(".gif"))
        need(gifs == ([f"{n}.gif" for n in names] if "--save_gif" in flags else []),
             f"editing run ({tag}): GIFs {gifs}")
        results[tag] = {"wall_s": wall, "images": n_img}
        if tag == "a":
            kept = res

    # run (a)'s yaw sweep against a direct call on the same source
    a = model_loading.load_direction_matrix()
    trunc = model_loading.compute_trunc(kept["generator"]).cuda()
    spec = initialize_directions("voxceleb", 15, 6.0)

    def sweep():
        with torch.no_grad():
            return sweep_direction(kept["generator"], a, spec, kept["source_code"], 0,
                                   kept["params_source"], kept["angles_source"],
                                   truncation=0.7, truncation_latent=trunc)

    name, values, imgs = sweep()
    imgs = np.clip((imgs.float().cpu().numpy() + 1.0) * 127.5, 0, 255).astype(np.uint8)
    diff = max(int(np.abs(np.asarray(Image.open(os.path.join(
        CLI_DIR, "edit_a", name, f"{name}_{i:03d}.png"))).astype(int) - imgs[i]).max())
        for i in range(len(values)))
    print(f"[edit] run (a), {name}: its {len(values)} PNGs against a direct sweep_direction "
          f"call: max |diff| {diff} intensity units (limit {CLI_MAX_DIFF})")
    need(name == "yaw" and diff <= CLI_MAX_DIFF, "the editing CLI disagrees with the direct sweep")
    sweep()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t = statistics.median(times)
    results["sweep_ips"] = len(values) / t
    print(f"[edit] one sweep of {len(values)} images at {SIZE}² (shift, synthesis, float32): "
          f"{1e3 * t:.2f} ms, {len(values) / t:.2f} images/s (median of 5, host clock, "
          f"synchronized; {1e3 * min(times):.2f}-{1e3 * max(times):.2f} ms) on {smi}")
    return results, totals


def phase_invert(smi):
    """``cli/invert_images.py::main`` on the card at full width on a tree of
    INVERT_IDS x INVERT_VIDEOS x INVERT_FRAMES 256² PNGs, batch INVERT_BATCH:
    launches, layout, the codes and frames against a direct
    ``make_invert_fn`` on the same batches; then the images/s of that
    function over the tree."""
    from PIL import Image

    from stylegan_directions_face_reenactment_tpu_torch.cli import invert_images as cli
    from stylegan_directions_face_reenactment_tpu_torch.cli import model_loading
    from stylegan_directions_face_reenactment_tpu_torch.data import DatasetInversion
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
        fused_bias_act_calls, upfirdn2d_calls)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import make_invert_fn

    root = os.path.join(CLI_DIR, "vox")
    rs = np.random.RandomState(90)
    for i in range(INVERT_IDS):
        for v in range(INVERT_VIDEOS):
            d = os.path.join(root, f"id{i:05d}", f"video{v}", "frames_cropped")
            os.makedirs(d)
            for f in range(INVERT_FRAMES):
                Image.fromarray(rs.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)).save(
                    os.path.join(d, f"{f:05d}.png"))
    n = INVERT_IDS * INVERT_VIDEOS * INVERT_FRAMES
    batches = -(-n // INVERT_BATCH)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = cli.main(["--dataset_path", root, "--batch_size", str(INVERT_BATCH)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_all_counts()
    n_mlp = MODELS["voxceleb"]["n_mlp"]
    k1, k2 = len(upfirdn2d_calls(SIZE, CM, 1)), len(fused_bias_act_calls(SIZE, CM, 1))
    want = {"K1": batches * k1, "K1-bwd": 0, "K1-bwd down 2": 0,
            "K2": n_mlp + batches * k2, "K2-bwd": 0, "K3": 0, "K3-bwd": 0}
    print(f"[invert] {n} frames in {res['batches']} batches of {INVERT_BATCH}: wall "
          f"{wall:.3f} s (host clock, synchronized, loading included) on {smi}; launches "
          + ", ".join(f"{k} {got[k]} (expected {want[k]})" for k in got))
    need(res == {"frames": n, "batches": batches} and got == want,
         f"inversion: {res}, launches {got}, expected {want}")

    g = model_loading.load_generator()
    invert = make_invert_fn(model_loading.load_e4e(), g, truncation=0.7,
                            truncation_latent=model_loading.compute_trunc(g))
    ds = DatasetInversion(root, image_size=SIZE)
    images = np.stack([ds[i]["image"] for i in range(n)])
    worst_code, worst_png = 0.0, 0
    for b in range(batches):
        sl = slice(b * INVERT_BATCH, (b + 1) * INVERT_BATCH)
        inv, codes = (t.float().cpu().numpy() for t in invert(images[sl]))
        for j, e in enumerate(ds.entries[sl]):
            vdir = os.path.dirname(os.path.dirname(e["path"]))
            stored = np.load(os.path.join(vdir, "inversion", "latent_codes",
                                          e["filename"] + ".npy"))
            need(stored.shape == codes[j].shape and allclose_scaled(
                torch.from_numpy(stored), torch.from_numpy(codes[j]), 1e-4, 1e-4),
                f"inversion: code of {e['path']} disagrees with the direct call")
            worst_code = max(worst_code, float(np.abs(stored - codes[j]).max()))
            png = np.asarray(Image.open(os.path.join(vdir, "inversion", "frames",
                                                     e["filename"] + ".png"))).astype(int)
            direct = np.clip((inv[j] + 1.0) * 127.5, 0, 255).astype(np.uint8).astype(int)
            worst_png = max(worst_png, int(np.abs(png - direct).max()))
    print(f"[invert] against a direct make_invert_fn on the same batches: codes max |diff| "
          f"{worst_code:.3g} (rtol 1e-4, atol 1e-4·max), frames max |diff| {worst_png} "
          f"intensity units (limit {CLI_MAX_DIFF})")
    need(worst_png <= CLI_MAX_DIFF, "inversion: frames disagree with the direct call")
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for b in range(batches):
            invert(images[b * INVERT_BATCH:(b + 1) * INVERT_BATCH])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t = statistics.median(times)
    print(f"[invert] make_invert_fn over the {n} frames in batches of {INVERT_BATCH} (e4e, "
          f"synthesis, float32, host arrays in): {n / t:.2f} images/s (median of 3, host "
          f"clock, synchronized; {n / max(times):.2f}-{n / min(times):.2f}) on {smi}")
    return {"wall_s": wall, "ips": n / t}, got


# ---------------------------------------------------------------------------
# [train]: training the direction matrix A
# ---------------------------------------------------------------------------

def write_train_inputs():
    """The ArcFace IR-SE-50 file (``model_ir_se50.pth``) beside the CLI
    phase's files: the seeded backbone with each block's last batch-norm
    scale × IRSE_BN2_SCALE (undamped, its random body grows the activations
    about 18,000-fold, as e4e's does), and a tree of TRAIN_IDS x
    TRAIN_VIDEOS videos of TRAIN_FRAMES 256² frames in the VoxCeleb layout:
    each frame the generator's image of its W+ code (a video's codes share
    one mapped w), with the code as its inversion. Returns the tree."""
    from PIL import Image

    from stylegan_directions_face_reenactment_tpu_torch.cli import model_loading
    from stylegan_directions_face_reenactment_tpu_torch.configs import AUX_MODELS
    from stylegan_directions_face_reenactment_tpu_torch.models import mapping
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import generate_image
    from stylegan_directions_face_reenactment_tpu_torch.weights import init_id_backbone
    idb = init_id_backbone(7, device="cpu")
    with torch.no_grad():
        for blk in idb.body:
            blk.res_layer[4].weight.mul_(IRSE_BN2_SCALE)
    torch.save(idb.state_dict(), AUX_MODELS["ir_se50"])

    g = model_loading.load_generator()
    root = os.path.join(CLI_DIR, "train_vox")
    gen = torch.Generator(device="cuda").manual_seed(95)
    with torch.no_grad():
        for i in range(TRAIN_IDS):
            for v in range(TRAIN_VIDEOS):
                base = os.path.join(root, f"id{i:05d}", f"video{v}")
                dirs = [os.path.join(base, "frames_cropped"),
                        os.path.join(base, "inversion", "frames"),
                        os.path.join(base, "inversion", "latent_codes")]
                for d in dirs:
                    os.makedirs(d)
                w = mapping(g, torch.randn(1, 512, generator=gen, device="cuda"))
                codes = w[:, None].repeat(TRAIN_FRAMES, g.n_latent, 1) + 0.3 * torch.randn(
                    TRAIN_FRAMES, g.n_latent, 512, generator=gen, device="cuda")
                imgs = generate_image(g, codes, input_is_latent=True)
                u8 = ((imgs.clamp(-1, 1) + 1) * 127.5).round().to(torch.uint8).cpu().numpy()
                for f in range(TRAIN_FRAMES):
                    for d in dirs[:2]:
                        Image.fromarray(u8[f]).save(os.path.join(d, f"{f:06d}.png"))
                    np.save(os.path.join(dirs[2], f"{f:06d}.npy"), codes[f].cpu().numpy())
    return root


def train_models(device):
    """The CLI files' nets on ``device`` as the trainer loads them."""
    from stylegan_directions_face_reenactment_tpu_torch.cli import model_loading as ml
    from stylegan_directions_face_reenactment_tpu_torch.train import FrozenModels
    g = ml.load_generator(device=device)
    sfd, fan = ml.load_face_models(device=device)
    return FrozenModels(g, ml.load_deca(device=device), ml.load_id_backbone(device=device),
                        ml.load_lpips(device=device), ml.compute_trunc(g), fan, sfd)


def train_step_launches(method):
    """Launches of one train step at full width: each synthesis K1 12 and
    K2 13 (a z source adds its mapping, K2 a layer); the backward of the
    shifted synthesis K1-bwd on every blur (down 1) and skip upsample (down
    2) and K2-bwd on every StyledConv; K3 56 a shape pass (synthetic: the
    source, the target and the shifted image; paired with cached
    coefficients: the shifted image); no K3-bwd."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
        fused_bias_act_calls, upfirdn2d_calls)
    k1, k2 = upfirdn2d_calls(SIZE, CM, 1), len(fused_bias_act_calls(SIZE, CM, 1))
    synths, mappings = (3, 3) if method == "synthetic" else (1, 0)
    return {"K1": synths * len(k1), "K1-bwd": len(k1),
            "K1-bwd down 2": sum(c.up == 2 for c in k1),
            "K2": synths * k2 + mappings * MODELS["voxceleb"]["n_mlp"], "K2-bwd": k2,
            "K3": K3_PER_PASS * synths, "K3-bwd": 0}


def run_trainer_main(tag, flags, smi):
    """``run_trainer.main`` with a save every 2 steps, a log line every step
    and a validation set of TRAIN_BATCH samples (the CLI takes its cadence
    from ``TrainingArguments``' defaults); its launches and files."""
    import functools

    from stylegan_directions_face_reenactment_tpu_torch.cli import run_trainer
    from stylegan_directions_face_reenactment_tpu_torch.configs import arguments
    exp = os.path.join(CLI_DIR, f"train_{tag}")
    small = functools.partial(arguments.TrainingArguments, steps_per_log=1, steps_per_save=2,
                              validation_samples=TRAIN_BATCH)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(arguments, "TrainingArguments", small):
        trainer, a = run_trainer.main(flags + ["--batch_size", str(TRAIN_BATCH),
                                               "--test_batch_size", str(TRAIN_BATCH),
                                               "--experiment_path", exp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_all_counts()
    out = trainer.args.experiment_path
    logs = [json.loads(x) for x in open(os.path.join(out, "logs", "train_log.jsonl"))]
    evals = json.load(open(os.path.join(out, "logs", "eval_metrics.json")))
    saved = sorted(os.listdir(os.path.join(out, "models")))
    print(f"[train] ({tag}) run_trainer.main {' '.join(flags)} --batch_size {TRAIN_BATCH}: "
          f"wall {wall:.3f} s (host clock, synchronized, loading and the step-0 evaluation "
          f"included) on {smi}; {len(logs)} steps, losses "
          + ", ".join(f"{r['loss']:.3f}" for r in logs)
          + f"; step-0 evaluation CSIM {evals[0]['csim']:.4f}, pose {evals[0]['pose_error']:.3f}"
          f"°, exp {evals[0]['expression_error']:.4f}; saved {saved}; launches "
          + ", ".join(f"{k} {v}" for k, v in got.items()))
    need(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in logs)
         and evals[0]["step"] == 0 and bool(torch.isfinite(a.linear.weight).all())
         and os.path.exists(os.path.join(out, "images", "0000_reenactment.png")),
         f"[train] ({tag}): a loss, the evaluation or A is not finite, or a file is missing")
    need(got["K3-bwd"] == 0 and all(got[k] > 0 for k in got if k != "K3-bwd"),
         f"[train] ({tag}) launches {got}: every kernel but K3-bwd must launch")
    return trainer, logs, saved, got, wall


def time_train_step(tag, step, smi, method):
    """A step's median ms (CUDA-synchronized host clock) after a warm-up,
    its exact launches, K3's plans made (none once the warm-up made the
    step's shapes'), the peak memory, and a profile of TRAIN_PROFILED steps
    (device busy share, time by kernel class)."""
    from stylegan_directions_face_reenactment_tpu_torch.ops import fused_conv_block as k3
    for _ in range(TRAIN_WARM):
        step()
    torch.cuda.synchronize()
    times, counts = [], []
    plans = k3.fused_conv_block_cuda.plan_misses
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_TIMED):
        reset_counts()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        counts.append(read_all_counts())
    plans = k3.fused_conv_block_cuda.plan_misses - plans
    peak = torch.cuda.max_memory_allocated()
    want = train_step_launches(method)
    ms = statistics.median(times)
    print(f"[train] {tag} step at batch {TRAIN_BATCH}: {ms:.3f} ms (median of {TRAIN_TIMED} "
          f"after {TRAIN_WARM} warm-up, {min(times):.3f}-{max(times):.3f}; host clock, "
          f"synchronized), peak {peak} bytes ({peak / 2**30:.3f} GiB), loss "
          f"{float(loss['loss']):.4f}, on {smi}; launches a step "
          + ", ".join(f"{k} {v} (expected {want[k]})" for k, v in counts[-1].items())
          + f"; K3 plans made in the timed steps {plans} (expected 0)")
    need(all(c == want for c in counts) and not plans,
         f"[train] {tag}: launches {counts[-1]}, expected {want}; K3 plans {plans}")
    profile_request(f"[train] {tag}", f"{TRAIN_PROFILED} steps at batch {TRAIN_BATCH}",
                    lambda: [step() for _ in range(TRAIN_PROFILED)])
    return {"ms": ms, "ms_min": min(times), "ms_max": max(times), "peak_bytes": peak,
            "launches": counts[-1]}


def train_card_vs_cpu(spec, launches):
    """(c): one grads-only synthetic step at TRAIN_CPU_BATCH with the
    ``fan_frame`` alignment on the card and on the CPU, same weights (DECA's
    head × TRAIN_DECA_HEAD_SCALE on both) and draws, with the ID term out.
    Held: the loss terms and A's gradient of the full-reenactment step and
    of the default disentanglement-50 step (its second half's targets equal
    the source's coefficients but one, so the L1 shape losses sit at
    thousands of kinks around A's random init); for each, a witness that the
    card's gradient does not jump under a 1e-6 change of A; the loss terms
    with the ID term in; and a control, the card's step with its synthesis
    in bf16, whose gradient must fail the limit against the CPU's float32
    step. Printed: the ID term's gradient gap."""
    from stylegan_directions_face_reenactment_tpu_torch.configs import TrainingArguments
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import generate_image
    from stylegan_directions_face_reenactment_tpu_torch.train import (
        make_align_fn, make_synthetic_step, sample_draws)
    from stylegan_directions_face_reenactment_tpu_torch.weights import init_direction_matrix
    models = {"cpu": train_models("cpu"), "cuda": train_models("cuda")}
    for m in models.values():
        with torch.no_grad():
            m.deca.E_flame.layers[2].weight.mul_(TRAIN_DECA_HEAD_SCALE)
    runs = {"held": dict(disentanglement_50=False, lambda_identity=0.0),
            "disentanglement-50": dict(disentanglement_50=True, lambda_identity=0.0),
            "with ID": dict(disentanglement_50=False, lambda_identity=10.0),
            "bf16 control": dict(disentanglement_50=False, lambda_identity=0.0,
                                 train_compute_dtype="bfloat16")}
    out, kinks = {}, {}
    for tag, kw in runs.items():
        targs = TrainingArguments(batch_size=TRAIN_CPU_BATCH, deca_alignment="fan_frame", **kw)
        draws = sample_draws(torch.Generator().manual_seed(7), targs, spec, "cpu",
                             source=True, target=True)
        for dev, m in models.items():
            if tag == "bf16 control" and dev == "cpu":
                continue                        # held against the "held" run's CPU step
            d = type(draws)(*(None if x is None else x.to(dev) for x in draws))
            a = init_direction_matrix(9, device=dev)
            step_fn = make_synthetic_step(m, spec, targs, grads_only=True)
            reset_counts()
            terms, gr = step_fn(a, None, draws=d)
            out[(tag, dev)] = ({k: float(v) for k, v in terms.items()},
                               {k: v.cpu() for k, v in gr.items()})
            if dev == "cuda":
                launches.update(read_all_counts())
                if tag in ("held", "disentanglement-50"):
                    with torch.no_grad():
                        a.linear.weight.mul_(1 + 1e-6)
                    moved = step_fn(a, None, draws=d)[1]["weight"].cpu()
                    kinks[tag] = max_err(moved, gr["weight"].cpu()) / float(
                        gr["weight"].abs().max())
    card = models["cuda"]
    with torch.no_grad():
        src = generate_image(card.generator, draws.z_src.cuda(), truncation=0.7,
                             truncation_latent=card.truncation_latent)
        ok = int(make_align_fn(card, targs)((src + 1) / 2.00001)[1].sum())

    def gaps(tag, cpu_tag=None):
        (t_cpu, g_cpu), (t_card, g_card) = out[(cpu_tag or tag, "cpu")], out[(tag, "cuda")]
        terms = {k: abs(t_card[k] - v) / max(abs(v), 1e-12) for k, v in t_cpu.items()}
        grads = {k: max_err(g_card[k], v) / float(v.abs().max()) for k, v in g_cpu.items()}
        ok_t = set(t_cpu) == set(t_card) and all(v <= TRAIN_LOSS_RTOL for v in terms.values())
        ok_g = all(allclose_scaled(g_card[k], v, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL)
                   for k, v in g_cpu.items())
        return terms, grads, ok_t, ok_g

    def show(d):
        return ", ".join(f"{k} {v:.3g}" for k, v in d.items())

    held = {tag: gaps(tag) for tag in ("held", "disentanglement-50")}
    id_terms, _, ok_id, _ = gaps("with ID")
    bf_terms, bf_grads, _, bf_ok_g = gaps("bf16 control", "held")
    id_card = out[("with ID", "cuda")][1]["weight"] - out[("held", "cuda")][1]["weight"]
    id_cpu = out[("with ID", "cpu")][1]["weight"] - out[("held", "cpu")][1]["weight"]
    print(f"[train] (c) one grads-only synthetic step at batch {TRAIN_CPU_BATCH}, fan_frame (ok "
          f"frames {ok} of {TRAIN_CPU_BATCH}), DECA's head × {TRAIN_DECA_HEAD_SCALE}, same "
          f"weights and draws, lambda_identity 0; limits: loss terms rtol {TRAIN_LOSS_RTOL}, "
          f"A's gradient rtol {TRAIN_GRAD_RTOL} and atol {TRAIN_GRAD_ATOL}·max, witness "
          f"{TRAIN_WITNESS_MAX} of max")
    for tag, (terms, grads, ok_t, ok_g) in held.items():
        print(f"[train] (c) {tag}: loss terms |card - CPU| relative {show(terms)} ({ok_t}); "
              f"A's gradient max |card - CPU| of max {show(grads)} ({ok_g}); the card's "
              f"gradient at A·(1 + 1e-6) moves {kinks[tag]:.3g} of max (witness)")
    print(f"[train] (c) with the ID term in (lambda_identity 10), loss terms {show(id_terms)} "
          f"({ok_id}); printed, not held: the ID term's gradient (lambda_identity 10 less 0) "
          f"max |card - CPU| {max_err(id_card, id_cpu) / float(id_cpu.abs().max()):.3g} of its "
          f"max {float(id_cpu.abs().max()):.4g}")
    print(f"[train] (c) control, the card's step with its synthesis in bf16 against the CPU's "
          f"float32 step: loss terms {show(bf_terms)}; A's gradient max |card - CPU| of max "
          f"{show(bf_grads)} (within the limits: {bf_ok_g}; must be False)")
    need(all(kinks[tag] <= TRAIN_WITNESS_MAX for tag in kinks), "[train] (c): A's gradient "
         "jumps under a 1e-6 change of A (a kink of the loss lies there): no card-CPU "
         "comparison can hold")
    need(all(ok_t and ok_g for _, _, ok_t, ok_g in held.values()) and ok_id,
         "[train] (c): the card's step disagrees with the CPU's")
    need(not bf_ok_g and max(bf_grads.values()) > TRAIN_GRAD_ATOL,
         "[train] (c): the bf16 control passes the card-CPU limit: the limit cannot tell a "
         "lower-precision step")


def phase_train(smi):
    """[train]: training A at full width on the CLI phase's files (plus the
    IR-SE-50 file): (a) ``run_trainer.main`` synthetic, (b) paired on a tree
    the phase writes, (c) one grads-only synthetic step at batch
    TRAIN_CPU_BATCH on the card against the CPU; each method's step timed."""
    from stylegan_directions_face_reenactment_tpu_torch.configs import TrainingArguments
    from stylegan_directions_face_reenactment_tpu_torch.data import CustomDatasetPaired, Loader
    from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import generate_image
    from stylegan_directions_face_reenactment_tpu_torch.train import (
        make_align_fn, make_optimizer, make_paired_step, make_shape_program,
        make_synthetic_step)
    from stylegan_directions_face_reenactment_tpu_torch.weights import init_direction_matrix

    t0 = time.perf_counter()
    tree = write_train_inputs()
    print(f"[train] IR-SE-50 file and a tree of {TRAIN_IDS * TRAIN_VIDEOS} videos x "
          f"{TRAIN_FRAMES} generated 256² frames with their codes written in "
          f"{time.perf_counter() - t0:.1f} s")
    launches = Counter()
    _, logs_a, saved_a, got, wall_a = run_trainer_main(
        "a", ["--training_method", "synthetic", "--n_steps", str(TRAIN_STEPS)], smi)
    need(len(logs_a) == TRAIN_STEPS and saved_a == [f"A_matrix_{s:06d}.npz" for s in
                                                    range(2, TRAIN_STEPS, 2)],
         f"[train] (a): {len(logs_a)} steps logged, saved {saved_a}")
    launches.update(got)
    pairs = TRAIN_IDS * TRAIN_VIDEOS * 2
    _, logs_b, _, got, wall_b = run_trainer_main(
        "b", ["--training_method", "paired", "--n_steps", "1", "--train_dataset_path", tree,
              "--test_dataset_path", tree], smi)
    need(len(logs_b) == pairs // TRAIN_BATCH, f"[train] (b): {len(logs_b)} steps logged")
    launches.update(got)

    models = train_models("cuda")
    spec = initialize_directions()
    args = TrainingArguments(batch_size=TRAIN_BATCH)
    align = make_align_fn(models, args)
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        synth = generate_image(models.generator, torch.randn(
            TRAIN_BATCH, 512, generator=gen, device="cuda"), truncation=0.7,
            truncation_latent=models.truncation_latent)
        batch = next(iter(Loader(CustomDatasetPaired(tree, seed=0), TRAIN_BATCH, seed=0)))
        frames = torch.from_numpy(batch["target_img"]).cuda()
        ok_a = int(align((synth + 1) / 2.00001)[1].sum())
        ok_b = int(align((frames + 1) / 2.00001)[1].sum())
    print(f"[train] S3FD (gated on content) finds a face in {ok_a} of {TRAIN_BATCH} synthetic "
          f"frames and {ok_b} of {TRAIN_BATCH} tree frames (the rest take the whole-frame "
          "warp and the -180° sentinel: constant shape losses)")

    results = {}
    for tag, dtype in (("synthetic", "float32"), ("synthetic bf16", "bfloat16")):
        a = init_direction_matrix(1, device="cuda")
        targs = TrainingArguments(batch_size=TRAIN_BATCH, train_compute_dtype=dtype)
        step_fn = make_synthetic_step(models, spec, targs, make_optimizer(a, targs))
        g = torch.Generator(device="cuda").manual_seed(11)
        results[tag] = time_train_step(tag, lambda: step_fn(a, g), smi, "synthetic")
        launches.update(results[tag]["launches"])
    a = init_direction_matrix(1, device="cuda")
    targs = TrainingArguments(batch_size=TRAIN_BATCH, training_method="paired")
    shape = make_shape_program(models, targs)
    extra = [torch.from_numpy(batch[k]).cuda() for k in
             ("source_latent_code", "target_latent_code", "target_img")]
    extra += [*shape(torch.from_numpy(batch["source_img"]).cuda()), *shape(frames)]
    step_fn = make_paired_step(models, spec, targs, make_optimizer(a, targs), cached_shape=True)
    results["paired"] = time_train_step("paired (cached coefficients)",
                                        lambda: step_fn(a, None, *extra), smi, "paired")
    launches.update(results["paired"]["launches"])
    del models, step_fn, extra
    torch.cuda.empty_cache()

    train_card_vs_cpu(spec, launches)
    results["walls"] = (wall_a, wall_b)
    return results, launches


# ---------------------------------------------------------------------------
# [ddp]: data-parallel training (parallel/mesh.py)
# ---------------------------------------------------------------------------

DDP_WORLD_MAX = 4                     # (a)'s NCCL world: the cards present, at most 4
DDP_TIMED = 5                         # the timed steps a rank (median)
DDP_REDUCE_REPS = 20                  # the timed all-reduces of A's gradient and terms


def hold_kernels_at(batches, tag, devices=("cuda:0",)):
    """K1, K2, K3, K1-bwd and K2-bwd against their plain versions at the
    shapes a step (or a mesh slot's part) of each of ``batches`` images
    gives them (a synthesis, a FAN pass, the shifted synthesis's backward),
    float32 and bf16, on each of ``devices`` (a card's own launch plan and
    library handle), at phase 3's limits."""
    t0 = time.perf_counter()
    for dev in dict.fromkeys(devices):
        with torch.cuda.device(torch.device(dev)):
            for batch in sorted(set(batches)):
                _hold_kernels_at(batch, tag, dev)
    print(f"[{tag}] kernels held at batches {sorted(set(batches))} on "
          f"{list(dict.fromkeys(devices))} in {time.perf_counter() - t0:.1f} s")


def _hold_kernels_at(batch, tag, dev):
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
        fused_bias_act_bwd_cuda, fused_bias_act_cuda, fused_leaky_relu_bwd_plain,
        fused_leaky_relu_plain)
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_conv_block import (
        fused_conv_block_cuda, fused_conv_block_plain)
    from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
        fused_bias_act_calls, upfirdn2d_calls)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import (
        make_kernel, upfirdn2d, upfirdn2d_output_shape)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
        upfirdn2d_backward, upfirdn2d_bwd_cuda, upfirdn2d_cuda)
    k = make_kernel((1, 3, 3, 1), gain=4)
    gen = torch.Generator(device=dev).manual_seed(batch)
    worst, n = Counter(), 0
    for dtype in (torch.float32, torch.bfloat16):
        for call, x in k1_inputs(dtype, gen, batch):
            got, want = upfirdn2d_cuda(x, k, call.up, call.pad), upfirdn2d(x, k, up=call.up,
                                                                            pad=call.pad)
            oh, ow = upfirdn2d_output_shape(x.shape[2], x.shape[3], (4, 4), up=call.up,
                                            pad=call.pad)
            g = torch.randn(x.shape[:2] + (oh, ow), generator=gen, device=dev).to(dtype)
            got_b = upfirdn2d_bwd_cuda(g, k, call.up, call.pad, call.shape)
            want_b = upfirdn2d_backward(g, k, call.up, call.pad, call.shape)
            for name, a, b in (("K1", got, want), ("K1-bwd", got_b, want_b)):
                err = max_err(a, b)
                need(a.shape == b.shape and err <= limit_for(b),
                     f"{tag}: {name} {call.name} {tuple(x.shape)} {dtype} disagrees")
                worst[(name, str(dtype)[6:])] = max(worst[(name, str(dtype)[6:])], err)
                n += 1
        for s in fused_bias_act_calls(SIZE, CM, batch) + [(batch, 512)]:
            x = torch.randn(s, generator=gen, device=dev).to(dtype)
            b = torch.randn(s[1], generator=gen, device=dev)
            g = torch.randn(s, generator=gen, device=dev).to(dtype)
            y = fused_leaky_relu_plain(x, b)
            for name, a, w in (("K2", fused_bias_act_cuda(x, b), y),
                               ("K2-bwd", fused_bias_act_bwd_cuda(g, y),
                                fused_leaky_relu_bwd_plain(g, y))):
                err = max_err(a, w)
                need(err <= limit_for(w), f"{tag}: {name} {s} {dtype} disagrees")
                worst[(name, str(dtype)[6:])] = max(worst[(name, str(dtype)[6:])], err)
                n += 1
        for shape, _, x, args in k3_inputs(dtype, gen, batch):
            got, want = fused_conv_block_cuda(x, args), fused_conv_block_plain(x, args)
            scale = max(1.0, float(want.float().abs().max()))
            lim = (K3_F32_TOL if dtype == torch.float32 else BF16_TOL) * scale
            err = max_err(got, want)
            need(got.shape == want.shape and err <= lim,
                 f"{tag}: K3 {shape} {dtype} disagrees")
            worst[("K3", str(dtype)[6:])] = max(worst[("K3", str(dtype)[6:])], err / scale)
            n += 1
    torch.cuda.synchronize()
    print(f"[{tag}] kernels at batch {batch}'s shapes on {dev} against their plain versions "
          f"({n} calls, phase 3's limits; K3 relative to max(1, max|plain|)): worst "
          + ", ".join(f"{k} {d} {v:.3g}" for (k, d), v in sorted(worst.items())))


def damped(models):
    """[train] (c)'s DECA: its head × TRAIN_DECA_HEAD_SCALE."""
    with torch.no_grad():
        models.deca.E_flame.layers[2].weight.mul_(TRAIN_DECA_HEAD_SCALE)
    return models


def ddp_args(held):
    """The steps' arguments, the ID term out: for (a) the defaults else
    (its ArcFace pools with ``adaptive_avg_pool2d``, whose CUDA backward
    adds with atomics: no two runs of a step with it are bit-equal), for
    (b) [train] (c)'s held settings (``fan_frame`` too), and for (b) the
    same two steps with the ID term in at its default weight ("paired ID",
    "synthetic ID")."""
    from stylegan_directions_face_reenactment_tpu_torch.configs import TrainingArguments
    kw = dict(lambda_identity=0.0)
    if held:
        kw["deca_alignment"] = "fan_frame"
    out = {"paired": TrainingArguments(batch_size=TRAIN_BATCH, training_method="paired",
                                       **kw),
           "synthetic": TrainingArguments(batch_size=TRAIN_BATCH, **kw)}
    if held:
        for tag in ("paired", "synthetic"):
            out[f"{tag} ID"] = dataclasses.replace(
                out[tag], lambda_identity=TrainingArguments().lambda_identity)
    return out


def ddp_extra(models, args, batch):
    """A paired batch's step inputs, cached coefficients included."""
    from stylegan_directions_face_reenactment_tpu_torch.train import make_shape_program
    shape = make_shape_program(models, args)
    extra = [torch.from_numpy(batch[k]).cuda() for k in
             ("source_latent_code", "target_latent_code", "target_img")]
    return extra + [*shape(torch.from_numpy(batch["source_img"]).cuda()),
                    *shape(torch.from_numpy(batch["target_img"]).cuda())]


def tree_to(x, device):
    """A tree (dicts, lists) with every tensor on ``device``."""
    if isinstance(x, dict):
        return {k: tree_to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [tree_to(v, device) for v in x]
    return x.to(device) if isinstance(x, torch.Tensor) else x


def step_result(a, terms):
    """(terms, A's gradient, A) after an optimizer step, on the CPU."""
    return ({k: float(v) for k, v in terms.items()},
            {n.split(".")[-1]: p.grad.detach().cpu().clone() for n, p in a.named_parameters()},
            {n.split(".")[-1]: p.detach().cpu().clone() for n, p in a.named_parameters()})


class deterministic:
    """cuDNN's deterministic algorithms and PyTorch's deterministic ops
    inside the block (warnings where an op has none): (a)'s comparison
    needs two runs of one step to be bit-equal."""

    def __enter__(self):
        self.before = (torch.backends.cudnn.deterministic,
                       torch.are_deterministic_algorithms_enabled())
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.before[0]
        torch.use_deterministic_algorithms(self.before[1])


def ddp_rank(mode, inputs_path):
    """A rank of [ddp] (a) (``mode`` "a": NCCL, a card a rank, the
    defaults) or (b) ("b": gloo, both ranks on card 0, [train] (c)'s held
    settings): the paired step's (and for (b) the synthetic step's) first
    update of A from seed 1 on this rank's rows of the batch, then the
    paired step timed, its launches counted, and an all-reduce of A's
    gradient and terms timed."""
    import torch.distributed as dist

    from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
    from stylegan_directions_face_reenactment_tpu_torch.parallel import (
        shard_batch, world_info)
    from stylegan_directions_face_reenactment_tpu_torch.train import (
        make_optimizer, make_paired_step, make_synthetic_step)
    from stylegan_directions_face_reenactment_tpu_torch.weights import init_direction_matrix
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = world_info()
    held = mode == "b"
    models = train_models("cuda")
    if held:
        damped(models)
    args, spec = ddp_args(held), initialize_directions()
    extra = [shard_batch(x) for x in tree_to(torch.load(inputs_path, weights_only=False), "cuda")]
    out = {"device": str(torch.cuda.current_device())}
    a = init_direction_matrix(1, device="cuda")
    step = make_paired_step(models, spec, args["paired"], make_optimizer(a, args["paired"]),
                            cached_shape=True)
    if held:
        out["paired"] = step_result(a, step(a, None, *extra))
    else:
        with deterministic():
            out["paired"] = step_result(a, step(a, None, *extra))
    if held:
        for tag in ("synthetic", "paired ID", "synthetic ID"):
            a_s = init_direction_matrix(1, device="cuda")
            if tag.startswith("paired"):
                s_step = make_paired_step(models, spec, args[tag],
                                          make_optimizer(a_s, args[tag]), cached_shape=True)
                out[tag] = step_result(a_s, s_step(a_s, None, *extra))
            else:
                s_step = make_synthetic_step(models, spec, args[tag],
                                             make_optimizer(a_s, args[tag]))
                out[tag] = step_result(
                    a_s, s_step(a_s, torch.Generator(device="cuda").manual_seed(11)))
    step(a, None, *extra)                                     # warm-up
    times, launches = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(DDP_TIMED):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        step(a, None, *extra)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        launches.append(read_all_counts())
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    flat = torch.randn(sum(p.numel() for p in a.parameters()) + len(out["paired"][0]),
                       device="cuda")
    reduce_ms = []
    for i in range(DDP_REDUCE_REPS + 3):
        dist.barrier()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_reduce(flat)
        end.record()
        torch.cuda.synchronize()
        if i >= 3:
            reduce_ms.append(start.elapsed_time(end))
    out.update(step_ms=statistics.median(times), step_ms_range=(min(times), max(times)),
               launches=launches, reduce_ms=statistics.median(reduce_ms),
               reduce_numel=flat.numel(), rows=int(extra[0].shape[0]), rank=rank,
               world=world)
    return out


def one_process_step(models, args, builder, extra, gen_seed=None, scale=1.0, **kw):
    """The one-process batch-TRAIN_BATCH step from A at seed 1 (its weight
    × ``scale``): (terms, gradient, A) after the optimizer step."""
    from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
    from stylegan_directions_face_reenactment_tpu_torch.train import make_optimizer
    from stylegan_directions_face_reenactment_tpu_torch.weights import init_direction_matrix
    a = init_direction_matrix(1, device="cuda")
    with torch.no_grad():
        a.linear.weight.mul_(scale)
    gen = None if gen_seed is None else torch.Generator(device="cuda").manual_seed(gen_seed)
    step = builder(models, initialize_directions(), args, make_optimizer(a, args), **kw)
    return step_result(a, step(a, gen, *extra))


def held_against(tag, rank_res, plain, witness):
    """(b)'s comparison of a rank's step with the one-process step, at
    [train] (c)'s limits: the loss terms rtol TRAIN_LOSS_RTOL; A's
    gradient rtol TRAIN_GRAD_RTOL, atol TRAIN_GRAD_ATOL·max; A's update,
    Adam's first (about ±lr an element, by the sign of gradient + weight
    decay), equal except where that sum is within the gradient's atol of
    0, and never more than 2·lr apart. Returns the printed gaps."""
    terms, grads, weights = rank_res
    p_terms, p_grads, p_weights = plain
    t_gap = {k: abs(terms[k] - v) / max(abs(v), 1e-12) for k, v in p_terms.items()
             if k != "grad_norm"}
    g_gap = {k: max_err(grads[k], v) / float(v.abs().max()) for k, v in p_grads.items()}
    ok_t = set(terms) == set(p_terms) and all(v <= TRAIN_LOSS_RTOL for v in t_gap.values())
    ok_g = all(allclose_scaled(grads[k], v, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL)
               for k, v in p_grads.items())
    from stylegan_directions_face_reenactment_tpu_torch.configs import TrainingArguments
    from stylegan_directions_face_reenactment_tpu_torch.weights import init_direction_matrix
    start = dict(init_direction_matrix(1, device="cpu").linear.named_parameters())
    lr = TrainingArguments().lr
    flips, ok_a = 0, True
    for k, w in p_weights.items():
        moved = (weights[k] - w).abs()
        # the gradient Adam saw: A's gradient plus the weight decay term
        g_eff = p_grads[k] + TrainingArguments().weight_decay * start[k].detach()
        near_zero = g_eff.abs() <= TRAIN_GRAD_ATOL * float(p_grads[k].abs().max())
        differ = moved > 1e-3 * lr
        flips += int(differ.sum())
        ok_a = ok_a and bool((moved <= 2.001 * lr).all()) and bool((~differ | near_zero).all())
    print(f"[ddp] (b) {tag}: loss terms |rank - one process| relative "
          + ", ".join(f"{k} {v:.3g}" for k, v in t_gap.items())
          + f" ({ok_t}); A's gradient max |diff| of max "
          + ", ".join(f"{k} {v:.3g}" for k, v in g_gap.items())
          + f" ({ok_g}); A's update differs in {flips} elements, each where the gradient "
          f"Adam saw is within the atol of 0 ({ok_a}); witness {witness:.3g} of max")
    need(witness <= TRAIN_WITNESS_MAX, f"[ddp] (b) {tag}: the one-process gradient jumps "
         "under a 1e-6 change of A: no comparison can hold")
    need(ok_t and ok_g and ok_a, f"[ddp] (b) {tag}: a rank of the world of 2 disagrees with "
         "the one-process step")


def id_held_against(tag, ranks, plain):
    """(b) with the ID term in: every rank's loss terms, ``loss_identity``
    included, against the one-process step's at [train] (c)'s rtol
    TRAIN_LOSS_RTOL, and A's gradient at its rtol TRAIN_GRAD_RTOL and atol
    TRAIN_GRAD_ATOL·max (ArcFace's pooling backward adds with atomics, so
    the update is not compared element by element)."""
    p_terms, p_grads, _ = plain
    for r in ranks:
        terms, grads, _ = r[tag]
        t_gap = {k: abs(terms[k] - v) / max(abs(v), 1e-12) for k, v in p_terms.items()
                 if k != "grad_norm"}
        g_gap = {k: max_err(grads[k], v) / float(v.abs().max()) for k, v in p_grads.items()}
        ok_t = (set(terms) == set(p_terms) and "loss_identity" in t_gap
                and all(v <= TRAIN_LOSS_RTOL for v in t_gap.values()))
        ok_g = all(allclose_scaled(grads[k], v, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL)
                   for k, v in p_grads.items())
        print(f"[ddp] (b) {tag} (lambda_identity at its default), rank {r['rank']}: loss "
              "terms |rank - one process| relative "
              + ", ".join(f"{k} {v:.3g}" for k, v in t_gap.items())
              + f" ({ok_t}); A's gradient max |diff| of max "
              + ", ".join(f"{k} {v:.3g}" for k, v in g_gap.items()) + f" ({ok_g})")
        need(ok_t and ok_g, f"[ddp] (b) {tag}: rank {r['rank']} disagrees with the "
             "one-process step")


def print_ranks(label, ranks, want, smi):
    for r in ranks:
        need(all(c == want for c in r["launches"]),
             f"[ddp] {label} rank {r['rank']}: launches {r['launches'][-1]}, expected {want}")
        print(f"[ddp] {label} rank {r['rank']} of {r['world']} (cuda:{r['device']}, "
              f"{r['rows']} rows): paired step (cached coefficients) {r['step_ms']:.3f} ms "
              f"(median of {DDP_TIMED}, {r['step_ms_range'][0]:.3f}-"
              f"{r['step_ms_range'][1]:.3f}; host clock, synchronized), all-reduce of "
              f"{r['reduce_numel']} float32 (A's gradient and the terms) "
              f"{r['reduce_ms']:.4f} ms (CUDA events, median of {DDP_REDUCE_REPS}), peak "
              f"{r['peak_bytes']} bytes ({r['peak_bytes'] / 2**30:.3f} GiB), launches a step "
              + ", ".join(f"{k} {v}" for k, v in r["launches"][-1].items())
              + f" (expected {dict(want)}) on {smi}")


def phase_ddp(smi, tree, parts=("a", "b", "c")):
    """[ddp]: (a) the paired step over an NCCL world of the cards present
    (at most DDP_WORLD_MAX) against the one-process step; (b) two gloo
    ranks on card 0, each half of a batch-12 paired and synthetic step,
    against the one-process steps at [train] (c)'s limits, and both again
    with the ID term in (terms and gradient held); (c)
    ``run_trainer.main --n_devices`` over the cards when there are two or
    more. The kernels are held at the per-rank shapes."""
    from stylegan_directions_face_reenactment_tpu_torch.data import CustomDatasetPaired, Loader
    from stylegan_directions_face_reenactment_tpu_torch.train import (
        make_paired_step, make_synthetic_step)
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    world_a = min(cards, DDP_WORLD_MAX)
    if cards > 1:
        r = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60)
        print("[ddp] the cards: " + "; ".join(r.stdout.strip().splitlines()))
    batch = next(iter(Loader(CustomDatasetPaired(tree, seed=0), TRAIN_BATCH, seed=0)))
    launches = Counter()
    paths, plain = {}, {}
    ranks, ranks_b = [], []
    for mode in [p for p in ("a", "b") if p in parts]:
        models = train_models("cuda")
        if mode == "b":
            damped(models)
        args = ddp_args(mode == "b")
        extra = ddp_extra(models, args["paired"], batch)
        paths[mode] = os.path.join(CLI_DIR, f"ddp_inputs_{mode}.pt")
        torch.save(tree_to(extra, "cpu"), paths[mode])
        if mode == "a":
            # twice with deterministic algorithms (bit-equal, or no comparison
            # with the world's step can be), once without
            with deterministic():
                runs = [one_process_step(models, args["paired"], make_paired_step, extra,
                                         cached_shape=True) for _ in range(2)]
            free = one_process_step(models, args["paired"], make_paired_step, extra,
                                    cached_shape=True)
            plain["a"] = {"paired": runs[0]}
            self_equal = all(torch.equal(runs[0][2][k], runs[1][2][k]) for k in runs[0][2])
            free_gap = {k: max_err(free[1][k], v) / float(v.abs().max())
                        for k, v in runs[0][1].items()}
            print(f"[ddp] the one-process paired step run twice with deterministic "
                  f"algorithms: A's update bit-equal {self_equal}; without them, A's "
                  "gradient max |diff| of max "
                  + ", ".join(f"{k} {v:.3g}" for k, v in free_gap.items()))
            need(self_equal, "[ddp]: the deterministic one-process step is not reproducible")
        else:
            plain[mode] = {"paired": one_process_step(models, args["paired"],
                                                      make_paired_step, extra,
                                                      cached_shape=True)}
        if mode == "b":
            moved = one_process_step(models, args["paired"], make_paired_step, extra,
                                     scale=1 + 1e-6, cached_shape=True)
            plain["b"]["synthetic"] = one_process_step(models, args["synthetic"],
                                                       make_synthetic_step, [], gen_seed=11)
            plain["b"]["paired ID"] = one_process_step(models, args["paired ID"],
                                                       make_paired_step, extra,
                                                       cached_shape=True)
            plain["b"]["synthetic ID"] = one_process_step(models, args["synthetic ID"],
                                                          make_synthetic_step, [], gen_seed=11)
            moved_s = one_process_step(models, args["synthetic"], make_synthetic_step, [],
                                       gen_seed=11, scale=1 + 1e-6)
            witness = {tag: max_err(m[1]["weight"], plain["b"][tag][1]["weight"])
                       / float(plain["b"][tag][1]["weight"].abs().max())
                       for tag, m in (("paired", moved), ("synthetic", moved_s))}
        del models
        torch.cuda.empty_cache()

    # (a) NCCL, a card a rank
    if "a" in parts:
        ranks = ddp_world_a(smi, paths["a"], plain["a"], world_a, cards, launches)
    if "b" in parts:
        ranks_b = ddp_world_b(smi, paths["b"], plain["b"], witness, launches)
    if "c" in parts:
        ddp_cli(smi, cards)
    # the kernels at the rows a rank: (b)'s two ranks on card 0, and the
    # multi-card worlds' on each of their cards
    if "b" in parts:
        hold_kernels_at([TRAIN_BATCH // 2], "ddp")
    multi = [TRAIN_BATCH // world_a] if "a" in parts and world_a > 1 else []
    if "c" in parts and cards >= 2:
        n, b = ddp_cli_world(cards)
        multi.append(b // n)
    if multi:
        hold_kernels_at(multi, "ddp", [f"cuda:{i}" for i in range(world_a)])
    print(f"[ddp] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, ranks, ranks_b


def ddp_world_a(smi, path, plain, world_a, cards, launches):
    """(a): the paired step over an NCCL world of ``world_a`` cards."""
    from stylegan_directions_face_reenactment_tpu_torch.parallel import launch
    t0 = time.perf_counter()
    ranks = launch(ddp_rank, world_a, "a", path, backend="nccl", timeout=600)
    wall_a = time.perf_counter() - t0
    want = Counter(train_step_launches("paired"))
    print_ranks("(a) NCCL", ranks, want, smi)
    for r in ranks:
        for c in r["launches"]:
            launches.update(c)
    w0 = ranks[0]["paired"][2]
    same = all(torch.equal(r["paired"][2][k], w0[k]) for r in ranks for k in w0)
    if world_a == 1:
        equal = all(torch.equal(w0[k], plain["paired"][2][k]) for k in w0)
        gap = {k: max_err(ranks[0]["paired"][1][k], v) / float(v.abs().max())
               for k, v in plain["paired"][1].items()}
        print(f"[ddp] (a) a world of 1 (cards present: {cards}): A's update from the "
              f"data-parallel step bit-equal to the plain step's (deterministic algorithms "
              f"in both): {equal} (gradient max |diff| of max "
              + ", ".join(f"{k} {v:.3g}" for k, v in gap.items()) + f"); world wall "
              f"{wall_a:.3f} s (spawn, set-up and the timed steps) on {smi}")
        need(equal, "[ddp] (a): the data-parallel step's update differs from the plain step's")
    else:
        # the all-reduce sums the ranks' gradients in its own order:
        # printed, not held; the held comparison is (b)'s
        terms, grads, _ = ranks[0]["paired"]
        p_terms, p_grads, _ = plain["paired"]
        print(f"[ddp] (a) a world of {world_a}: against the one-process step (printed, not "
              "held): loss terms relative "
              + ", ".join(f"{k} {abs(terms[k] - v) / max(abs(v), 1e-12):.3g}"
                          for k, v in p_terms.items())
              + "; A's gradient max |diff| of max "
              + ", ".join(f"{k} {max_err(grads[k], v) / float(v.abs().max()):.3g}"
                          for k, v in p_grads.items())
              + f"; world wall {wall_a:.3f} s on {smi}")
    need(same, "[ddp] (a): the ranks hold different A after the step")
    return ranks


def ddp_world_b(smi, path, plain, witness, launches):
    """(b): two gloo ranks on card 0 against the one-process steps."""
    from stylegan_directions_face_reenactment_tpu_torch.parallel import launch
    want = Counter(train_step_launches("paired"))
    t0 = time.perf_counter()
    ranks_b = launch(ddp_rank, 2, "b", path, backend="gloo", timeout=600)
    wall_b = time.perf_counter() - t0
    print_ranks("(b) gloo on one card", ranks_b, want, smi)
    for r in ranks_b:
        for c in r["launches"]:
            launches.update(c)
    for tag in ("paired", "synthetic"):
        need(all(torch.equal(r[tag][2][k], ranks_b[0][tag][2][k]) for r in ranks_b
                 for k in ranks_b[0][tag][2]), f"[ddp] (b) {tag}: the ranks hold different A")
        held_against(tag, ranks_b[0][tag], plain[tag], witness[tag])
    for tag in ("paired ID", "synthetic ID"):
        id_held_against(tag, ranks_b, plain[tag])
    print(f"[ddp] (b) world wall {wall_b:.3f} s (spawn, set-up and the timed steps)")
    return ranks_b


def ddp_cli_world(cards):
    """(c)'s world and global batch: TRAIN_BATCH rounded up so that each
    disentanglement-50 half divides the world."""
    n = min(cards, DDP_WORLD_MAX)
    return n, 2 * n * -(-TRAIN_BATCH // (2 * n))


def ddp_cli(smi, cards):
    """(c): ``run_trainer.main --n_devices`` over the cards, 2 steps."""
    from stylegan_directions_face_reenactment_tpu_torch.cli import run_trainer
    if cards >= 2:
        n, b = ddp_cli_world(cards)
        t0 = time.perf_counter()
        _, a = run_trainer.main(["--training_method", "synthetic", "--n_steps", "2",
                                 "--batch_size", str(b), "--no_evaluation", "--n_devices",
                                 str(n), "--experiment_path", os.path.join(CLI_DIR, "ddp_c")])
        wall = time.perf_counter() - t0
        logs = [json.loads(x) for x in open(os.path.join(
            CLI_DIR, "ddp_c_voxceleb_synthetic", "logs", "train_log.jsonl"))]
        print(f"[ddp] (c) run_trainer.main --n_devices {n} --batch_size {b}, 2 steps: wall "
              f"{wall:.3f} s (spawn and loading included), losses "
              + ", ".join(f"{r['loss']:.3f}" for r in logs) + f" on {smi}")
        need(bool(torch.isfinite(a.linear.weight).all()) and len(logs) == 1,
             "[ddp] (c): A is not finite or the log is not rank 0's")
    else:
        print(f"[ddp] (c) run_trainer.main --n_devices: not run, {cards} card present (it "
              "spawns a rank a card; NCCL refuses two ranks on one card)")


# ---------------------------------------------------------------------------
# [mesh]: frame data parallelism in one process
# ---------------------------------------------------------------------------

MESH_REQUEST, MESH_RUNS = 16, 5


def phase_mesh(smi):
    """[mesh]: ``make_mesh`` past the cards raises; a slice-2 request of 16
    raw frames through ``make_fused_reenact_fn`` over a two-slot mesh (two
    cards, or card 0 twice) against the one-device call, and both timed;
    once more in bf16, held at the bf16 synthesis limit; the kernels held at
    a slot's rows on each card of the mesh."""
    from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
    from stylegan_directions_face_reenactment_tpu_torch.models.stylegan2 import (
        mapping, mean_latent, style_to_wplus, synthesis)
    from stylegan_directions_face_reenactment_tpu_torch.parallel import make_mesh
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
        make_fused_reenact_fn, source_shape)
    cards = torch.cuda.device_count()
    try:
        make_mesh(cards + 1)
        raised = False
    except ValueError:
        raised = True
    need(raised, f"[mesh] make_mesh({cards + 1}) with {cards} card(s) did not raise")
    devs = ["cuda:0", "cuda:1"] if cards >= 2 else ["cuda:0", "cuda:0"]
    mesh = make_mesh(devices=devs)
    g, a, deca, sfd, fan = build_slice2_nets(None)
    spec = initialize_directions("voxceleb", 15, 6.0)
    with torch.inference_mode():
        trunc = mean_latent(g, torch.Generator().manual_seed(3), 4096)
        z = torch.randn(1, 512, generator=torch.Generator().manual_seed(4)).cuda()
        code = style_to_wplus(g, [mapping(g, z)])
        ps, ang = source_shape(deca, synthesis(g, code), fan, sfd)
    frames = torch.randint(0, 256, (MESH_REQUEST,) + FRAME_HW + (3,),
                           generator=torch.Generator().manual_seed(22),
                           dtype=torch.uint8).cuda()
    kw = dict(truncation=0.7, truncation_latent=trunc, fan_params=fan, s3fd_params=sfd,
              outputs="full")
    fns = {"one device": make_fused_reenact_fn(g, a, deca, spec, sfd, fan, **kw),
           f"mesh {devs}": make_fused_reenact_fn(g, a, deca, spec, sfd, fan, mesh=mesh, **kw)}
    outs, fps, launches = {}, {}, Counter()
    for tag, fn in fns.items():
        torch.cuda.synchronize()
        reset_counts()
        outs[tag] = fn(code, ps, ang, frames)
        torch.cuda.synchronize()
        got = read_counts()
        parts = 1 if tag == "one device" else 2
        want = (parts * K1_PER_REQUEST, parts * K2_PER_REQUEST, parts * K3_PER_REQUEST)
        need(got == want, f"[mesh] {tag}: K1/K2/K3 launched {got}, expected {want}")
        launches.update(dict(zip(("K1", "K2", "K3"), got)))
        rates = []
        for _ in range(MESH_RUNS):
            t0 = time.perf_counter()
            fn(code, ps, ang, frames)
            torch.cuda.synchronize()
            rates.append(MESH_REQUEST / (time.perf_counter() - t0))
        fps[tag] = (statistics.median(rates), min(rates), max(rates))
    (r1, l1, c1, ok1, in1, p1), (r2, l2, c2, ok2, in2, p2) = outs.values()
    img_ok = allclose_scaled(r2.float().cpu(), r1.float().cpu(), 1e-3, 2e-4)
    lat_ok = allclose_scaled(l2.cpu(), l1.cpu(), 1e-4, 1e-4)
    same_masks = torch.equal(ok1, ok2) and torch.equal(in1, in2) and torch.equal(p1, p2)
    crop_diff = int((c1.int() - c2.int()).abs().max())
    print(f"[mesh] make_mesh({cards + 1}) with {cards} card(s) raises ValueError; "
          f"make_fused_reenact_fn over {devs} on a request of {MESH_REQUEST} raw "
          f"{FRAME_HW[0]}x{FRAME_HW[1]} frames against one device: images rtol 1e-3, atol "
          f"2e-4*max {img_ok} (max |diff| {max_err(r2, r1):.3g}); latents {lat_ok}; ok, "
          f"in_frame and landmarks identical, in frame order {same_masks}; crops max diff "
          f"{crop_diff}; " + "; ".join(f"{tag} {v[0]:.2f} frames/s (median of {MESH_RUNS}, "
                                      f"{v[1]:.2f}-{v[2]:.2f})" for tag, v in fps.items())
          + f" on {smi}")
    need(img_ok and lat_ok and same_masks and crop_diff <= 1,
         "[mesh] the mesh's frames disagree with the one-device call")
    # bf16 (K3's wgmma path on each card of the mesh), once each
    kw16 = dict(kw, compute_dtype=torch.bfloat16)
    reset_counts()
    b2 = make_fused_reenact_fn(g, a, deca, spec, sfd, fan, mesh=mesh, **kw16)(
        code, ps, ang, frames)
    torch.cuda.synchronize()
    launches.update(dict(zip(("K1", "K2", "K3"), read_counts())))
    b1 = make_fused_reenact_fn(g, a, deca, spec, sfd, fan, **kw16)(code, ps, ang, frames)
    drift = mean_rel(b2[0].float(), b1[0].float())
    print(f"[mesh] bf16 over {devs} against one device: ok and in_frame identical "
          f"{torch.equal(b1[3], b2[3]) and torch.equal(b1[4], b2[4])}, image mean relative "
          f"drift {drift:.3g} (limit {BF16_SYNTH})")
    need(torch.equal(b1[3], b2[3]) and torch.equal(b1[4], b2[4]) and drift <= BF16_SYNTH,
         "[mesh] bf16: the mesh's frames disagree with the one-device call")
    # each slot's part: K1, K2 and K3 at its rows, on each card of the mesh
    hold_kernels_at([MESH_REQUEST // len(devs)], "mesh", devs)
    return launches, fps


# ---------------------------------------------------------------------------
# [stats] and [report]: the metric CLIs
# ---------------------------------------------------------------------------

STATS_SAMPLES, STATS_BATCH, STATS_CPU = 64, 16, 8
REPORT_FRAMES, REPORT_CPU_FRAMES = 16, 2


def phase_stats(smi):
    """[stats]: ``extract_statistics.main`` on the CLI files (``fan``
    alignment) for STATS_SAMPLES samples at batch STATS_BATCH, timed; its
    first STATS_CPU draws (one batch) on the card against the CPU: angles atol 1e-2
    degrees, jaw and expressions rtol 1e-3 and atol 1e-3·max|column| (the
    DECA encoder bound)."""
    from stylegan_directions_face_reenactment_tpu_torch.cli import extract_statistics as st
    from stylegan_directions_face_reenactment_tpu_torch.cli import model_loading as ml
    out = os.path.join(CLI_DIR, "stats")
    argv = ["--batch_size", str(STATS_BATCH), "--deca_alignment", "fan"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    r64 = st.main(argv + ["--num_samples", str(STATS_SAMPLES), "--output_path", out + "_64"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_all_counts()
    # the per-batch program alone, on loaded nets
    g = ml.load_generator()
    deca = ml.load_deca()
    sfd, fan = ml.load_face_models()
    trunc = ml.compute_trunc(g)
    gen = torch.Generator().manual_seed(0)
    zs = [torch.randn((STATS_BATCH, 512), generator=gen).cuda()
          for _ in range(STATS_SAMPLES // STATS_BATCH)]
    st.batch_rows(g, deca, zs[0], truncation=0.7, truncation_latent=trunc, fan=fan, s3fd=sfd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for z in zs:
        st.batch_rows(g, deca, z, truncation=0.7, truncation_latent=trunc, fan=fan, s3fd=sfd)
    torch.cuda.synchronize()
    sps = STATS_SAMPLES / (time.perf_counter() - t0)
    small = ["--batch_size", str(STATS_CPU), "--deca_alignment", "fan", "--num_samples",
             str(STATS_CPU)]
    card = st.main(small + ["--output_path", out + "_card"])
    t0 = time.perf_counter()
    cpu = st.main(small + ["--output_path", out + "_cpu", "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    ang_err = float(np.abs(card[:3] - cpu[:3]).max())
    rest_ok = bool(np.all(np.abs(card[3:] - cpu[3:])
                          <= 1e-3 * np.abs(cpu[3:]).max(axis=1, keepdims=True)
                          + 1e-3 * np.abs(cpu[3:])))
    rest_err = float((np.abs(card[3:] - cpu[3:]).max(axis=1)
                      / np.abs(cpu[3:]).max(axis=1).clip(1e-12)).max())
    print(f"[stats] extract_statistics.main --num_samples {STATS_SAMPLES} --batch_size "
          f"{STATS_BATCH} --deca_alignment fan: wall {wall:.3f} s (loading included), ranges "
          f"{r64.shape} {r64.dtype}; the per-batch program alone {sps:.2f} samples/s on "
          f"{smi}; launches " + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; the first {STATS_CPU} draws card vs CPU ({cpu_s:.1f} s on the CPU): angles "
          f"max |diff| {ang_err:.3g} deg (atol 1e-2), jaw and expressions worst max |diff| "
          f"of max|column| {rest_err:.3g} (rtol 1e-3, atol 1e-3*max: {rest_ok})")
    need(r64.shape == (54, 2) and np.isfinite(r64).all() and (r64[:, 0] <= r64[:, 1]).all(),
         "[stats] the ranges are not a finite (54, 2) min/max table")
    need(ang_err <= 1e-2 and rest_ok, "[stats] the card's ranges disagree with the CPU's")
    need(launches["K1"] > 0 and launches["K2"] > 0 and launches["K3"] > 0,
         f"[stats] launches {launches}")
    return launches, sps, wall


def phase_report(smi, targets):
    """[report]: ``parity_report.main`` on the CLI phase's target PNGs,
    self-reenactment, no PTI: REPORT_FRAMES frames on the card (timed);
    the first REPORT_CPU_FRAMES on the card and on the CPU, whose reports
    must hold the same keys and values and metrics within CSIM atol 2e-3,
    pose atol 0.1 degree, expression atol 2e-3."""
    from stylegan_directions_face_reenactment_tpu_torch.cli import parity_report
    argv = ["--target_path", targets, "--no-optimize_generator"]
    out = os.path.join(CLI_DIR, "report")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rep = parity_report.main(argv + ["--max_frames", str(REPORT_FRAMES), "--output_path",
                                     out + "_16"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_all_counts()
    small = argv + ["--max_frames", str(REPORT_CPU_FRAMES)]
    card = parity_report.main(small + ["--output_path", out + "_card"])
    t0 = time.perf_counter()
    cpu = parity_report.main(small + ["--output_path", out + "_cpu", "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    same = (set(rep) == set(cpu) == set(card)
            and all(card[k] == cpu[k] for k in cpu if k not in ("metrics", "per_frame_std")))
    gaps = {k: abs(card["metrics"][k] - cpu["metrics"][k]) for k in cpu["metrics"]}
    lims = {"csim": 2e-3, "pose_error_deg": 0.1, "expression_error": 2e-3}
    print(f"[report] parity_report.main --max_frames {REPORT_FRAMES} (self-reenactment, no "
          f"PTI): wall {wall:.3f} s (loading and set-up included) on {smi}; metrics "
          + ", ".join(f"{k} {v:.4f}" for k, v in rep["metrics"].items())
          + f" over {rep['n_frames']} frames ({rep['n_frames_dropped_no_detection']} dropped); "
          f"launches " + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; {REPORT_CPU_FRAMES} frames card vs CPU ({cpu_s:.1f} s on the CPU): keys and "
          f"values equal {same}; |card - CPU| "
          + ", ".join(f"{k} {v:.3g} (atol {lims[k]})" for k, v in gaps.items()))
    need(same and all(gaps[k] <= lims[k] for k in gaps),
         "[report] the card's report disagrees with the CPU's")
    need(launches["K1"] > 0 and launches["K2"] > 0 and launches["K3"] > 0,
         f"[report] launches {launches}")
    return launches, wall


# [serve]: the serving bundle (serving.py) against the live entry point
SERVE_REQUESTS = (16, 16, 5, 37)        # frames; 5 pads a chunk, 37 takes three
SERVE_BATCH = 16                        # the bundle's frame batch
SERVE_WINDOW_S, SERVE_MIN_ROUNDS = 3.0, 10  # each of served and live, per dtype
SERVE_PTI_STEPS = 20                    # the PTI-tuned generator of with_generator
# float32 at T = 16 in one process: the same operators on the same batch
# (expected bit-equal); across processes, and for padded and chunked requests
# (other batch sizes), cuDNN may pick other algorithms, which the random
# DECA -> dp -> A chain amplifies: the card-vs-CPU image bound of slice 1
# (rtol 1e-3, atol 2e-4·max)
SERVE_F32_EXACT, SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-3, 2e-4
SERVE_CHILD = r"""
import json, sys, time
import numpy as np, torch
torch.backends.cudnn.allow_tf32 = False        # as this script's every phase
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
from stylegan_directions_face_reenactment_tpu_torch import serving
from stylegan_directions_face_reenactment_tpu_torch.ops import fused_act, fused_conv_block, upfirdn2d_kernel
pkg = "stylegan_directions_face_reenactment_tpu_torch"
bad = [m for m in sys.modules if m.startswith((pkg + ".models", pkg + ".pipeline"))]
assert not bad, f"the serving process imported model code: {bad}"
kernels = (upfirdn2d_kernel.upfirdn2d_cuda, fused_act.fused_bias_act_cuda,
           fused_conv_block.fused_conv_block_cuda)
inp = np.load(sys.argv[3], allow_pickle=False)
src = (inp["code"], {k: inp["ps_" + k] for k in ("pose", "alpha_shp", "alpha_exp", "cam")},
       inp["ang"])
out, report = {}, {"import_s": time.perf_counter() - t0}
for tag, path in (("float32", sys.argv[1]), ("bfloat16", sys.argv[2])):
    t1 = time.perf_counter()
    prog = serving.load_reenact_bundle(path)
    report[tag + "_load_s"] = time.perf_counter() - t1
    start = 0
    for r, t in enumerate(json.loads(sys.argv[5])):
        for k in kernels:
            k.launches = 0
        img, lat = prog(*src, inp["targets"][start:start + t])
        torch.cuda.synchronize()
        report[f"{tag}_{r}_launches"] = [k.launches for k in kernels]
        out[f"{tag}_{r}_img"], out[f"{tag}_{r}_lat"] = img.cpu().numpy(), lat.cpu().numpy()
        start += t
np.savez(sys.argv[4], **out)
bad = [m for m in sys.modules if m.startswith((pkg + ".models", pkg + ".pipeline"))]
assert not bad, f"the serving process imported model code: {bad}"
report["no_model_modules"] = True
print(json.dumps(report))
"""


def phase_serve(smi):
    """[serve]: ``serving.py`` at full width (voxceleb 256, channel
    multiplier 1, ``fan`` alignment with S3FD, frame batch 16), float32 and
    bf16: ``export_reenact`` → ``save_reenact_bundle`` timed; a fresh
    process that must import no ``models`` or ``pipeline`` module loads both
    bundles and serves requests of 16, 16, 5 and 37 frames, each chunk
    launching exactly the live call's K1/K2/K3, while this process runs the
    live ``make_reenact_fn`` on the same requests and a PTI-tuned generator
    through ``with_generator``; the served outputs against the live ones;
    then served (the exported program in this process) against live
    frames/s over one window each, in turns. Returns (launches, results)."""
    from stylegan_directions_face_reenactment_tpu_torch import serving
    from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
    from stylegan_directions_face_reenactment_tpu_torch.models.stylegan2 import (
        generator_forward, mapping, mean_latent, style_to_wplus, synthesis)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
        make_reenact_fn, optimize_g, source_shape)
    from stylegan_directions_face_reenactment_tpu_torch.weights import init_lpips

    g, a, deca, sfd, fan = build_slice2_nets(None)
    spec = initialize_directions("voxceleb", 15, 6.0)
    with torch.inference_mode():
        trunc = mean_latent(g, torch.Generator().manual_seed(3), 4096)
        z = torch.randn(1, 512, generator=torch.Generator().manual_seed(4)).cuda()
        code = style_to_wplus(g, [mapping(g, z)])
        src_img = synthesis(g, code)
        ps, ang = source_shape(deca, src_img, fan, sfd)
        zt = torch.randn(sum(SERVE_REQUESTS), 512,
                         generator=torch.Generator().manual_seed(30)).cuda()
        targets = generator_forward(g, [zt], truncation=0.7,
                                    truncation_latent=trunc)[0].clamp(-1, 1)
    src = (code, ps, ang)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    expect = (K1_PER_REQUEST, K2_PER_REQUEST, K3_PER_PASS)
    want_nodes = {"sdfr.upfirdn2d.default": K1_PER_REQUEST,
                  "sdfr.fused_bias_act.default": K2_PER_REQUEST,
                  "sdfr.fused_conv_block.default": K3_PER_PASS}
    launches, results, lives, progs, dirs = [0, 0, 0], {}, {}, {}, {}
    child = None
    try:
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype)[6:]
            kw = dict(truncation_latent=trunc, compute_dtype=dtype, fan_params=fan,
                      s3fd_params=sfd)
            lives[tag] = make_reenact_fn(g, a, deca, spec, **kw)
            t0 = time.perf_counter()
            ep, weights, meta = serving.export_reenact(g, a, deca, spec,
                                                       frame_batch=SERVE_BATCH, **kw)
            t1 = time.perf_counter()
            dirs[tag] = os.path.join(tmp, tag)
            serving.save_reenact_bundle(dirs[tag], ep, weights, meta)
            t2 = time.perf_counter()
            nodes = Counter(str(n.target) for n in ep.graph.nodes if "sdfr" in str(n.target))
            need(dict(nodes) == want_nodes, f"{tag}: the exported graph's operators {nodes}")
            size = sum(os.path.getsize(os.path.join(dirs[tag], f))
                       for f in os.listdir(dirs[tag]))
            progs[tag] = serving.ReenactServingProgram(ep, weights, meta, torch.device("cuda"))
            results[tag] = {"export_s": t1 - t0, "save_s": t2 - t1, "bundle_bytes": size}
            print(f"[serve] {tag}: export_reenact {t1 - t0:.3f} s, save_reenact_bundle "
                  f"{t2 - t1:.3f} s, bundle {size} bytes; graph operators {dict(nodes)}")
        # a fresh serving process on both bundles, while the live calls run here
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, code=code.cpu().numpy(), ang=ang.cpu().numpy(),
                 targets=targets.cpu().numpy(),
                 **{"ps_" + k: v.cpu().numpy() for k, v in ps.items()})
        outs = os.path.join(tmp, "served.npz")
        t_child = time.perf_counter()
        child = subprocess.Popen([sys.executable, "-c", SERVE_CHILD, dirs["float32"],
                                  dirs["bfloat16"], inputs, outs, json.dumps(SERVE_REQUESTS)],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 cwd=os.path.dirname(os.path.abspath(__file__)))
        want = {}
        for tag, live in lives.items():
            start = 0
            for r, t in enumerate(SERVE_REQUESTS):
                reset_counts()
                img, lat = live(*src, targets[start:start + t])
                torch.cuda.synchronize()
                got = read_counts()
                need(got == expect, f"{tag} live request {r}: K1/K2/K3 {got}, want {expect}")
                want[(tag, r)] = (img.float().cpu(), lat.float().cpu())
                start += t
        # with_generator: a PTI-tuned generator swapped into the float32 program
        with torch.inference_mode():
            latent = generator_forward(g, [code], input_is_latent=True, truncation=0.7,
                                       truncation_latent=trunc, return_latents=True)[1]
        tuned, _ = optimize_g(g, latent, src_img, init_lpips(6), trunc,
                              opt_steps=SERVE_PTI_STEPS)
        reset_counts()
        img_t, _ = progs["float32"].with_generator(tuned)(*src, targets[:SERVE_BATCH])
        torch.cuda.synchronize()
        need(read_counts() == expect, f"with_generator: K1/K2/K3 {read_counts()}")
        for i in range(3):
            launches[i] += expect[i]
        w_img, _ = make_reenact_fn(tuned, a, deca, spec, truncation_latent=trunc,
                                   fan_params=fan, s3fd_params=sfd)(*src, targets[:SERVE_BATCH])
        err = max_err(img_t, w_img) / float(w_img.abs().max())
        moved = max_err(want[("float32", 0)][0], w_img.cpu()) / float(w_img.abs().max())
        need(err <= SERVE_F32_EXACT and moved > 1e-3,
             f"with_generator: max |served - live| {err:.3g} of max (limit "
             f"{SERVE_F32_EXACT}); the tuned generator moved the image {moved:.3g} of max")
        try:
            progs["float32"].with_generator(
                {k: v for k, v in list(tuned.state_dict().items())[1:]})
            need(False, "with_generator took a generator of other keys")
        except ValueError:
            pass
        print(f"[serve] with_generator({SERVE_PTI_STEPS} PTI steps' generator): max |served "
              f"- live| {err:.3g} of max; the tuning moved the image {moved:.3g} of max; a "
              f"generator of other keys refused")
        out, err_txt = child.communicate(timeout=600)
        child_s = time.perf_counter() - t_child
        need(child.returncode == 0, f"the serving process failed:\n{out}\n{err_txt[-4000:]}")
        report = json.loads(out.strip().splitlines()[-1])
        served = np.load(outs)
        for tag in lives:
            worst = {}
            for r_i, t in enumerate(SERVE_REQUESTS):
                chunks = -(-t // SERVE_BATCH)
                got_l = tuple(report[f"{tag}_{r_i}_launches"])
                need(got_l == tuple(chunks * e for e in expect),
                     f"{tag} served request {r_i} ({t} frames): K1/K2/K3 {got_l}, want "
                     f"{chunks} x {expect}")
                for i in range(3):
                    launches[i] += got_l[i]
                img = torch.from_numpy(served[f"{tag}_{r_i}_img"])
                lat = torch.from_numpy(served[f"{tag}_{r_i}_lat"])
                w_img, w_lat = want[(tag, r_i)]
                need(img.shape == w_img.shape and lat.shape == w_lat.shape
                     and bool(torch.isfinite(img).all()),
                     f"{tag} served request {r_i}: shapes {tuple(img.shape)}")
                worst[r_i] = (max_err(img, w_img) / float(w_img.abs().max()),
                              mean_rel(img, w_img), mean_rel(lat, w_lat))
                if tag == "float32":
                    need(allclose_scaled(img, w_img, SERVE_RTOL, SERVE_ATOL)
                         and allclose_scaled(lat, w_lat, SERVE_RTOL, SERVE_ATOL),
                         f"float32 served request {r_i} ({t} frames): beyond rtol "
                         f"{SERVE_RTOL}, atol {SERVE_ATOL}·max (max err {worst[r_i][0]:.3g} "
                         f"of max)")
                else:
                    need(worst[r_i][1] < BF16_DRIFT,
                         f"bf16 served request {r_i}: image mean relative drift "
                         f"{worst[r_i][1]:.4f} from the live call, limit {BF16_DRIFT}")
            results[tag]["load_s"] = report[tag + "_load_s"]
            results[tag]["worst"] = worst
            print(f"[serve] {tag}: served in a fresh process (imports {report['import_s']:.3f} "
                  f"s, load_reenact_bundle {report[tag + '_load_s']:.3f} s; no models/ or "
                  f"pipeline/ module imported) against the live make_reenact_fn, per "
                  f"request {SERVE_REQUESTS}: (max |diff| / max, image mean rel, latent "
                  f"mean rel) " + ", ".join(f"{t}: {e[0]:.3g} {e[1]:.3g} {e[2]:.3g}"
                                            for t, e in zip(SERVE_REQUESTS, worst.values()))
                  + f"; K1/K2/K3 {'/'.join(map(str, expect))} a chunk")
        print(f"[serve] the serving process took {child_s:.3f} s (beside the live calls)")
        # frames/s, served (the exported program here) against live, in turns
        with torch.inference_mode():
            for tag, live in lives.items():
                prog = progs[tag]
                reqs = [targets[i * SERVE_BATCH:(i + 1) * SERVE_BATCH] for i in range(2)]
                reset_counts()
                s_img, s_lat = prog(*src, reqs[0])
                torch.cuda.synchronize()
                need(read_counts() == expect, f"{tag} served in-process: K1/K2/K3 "
                     f"{read_counts()}")
                for i in range(3):
                    launches[i] += expect[i]
                l_img, l_lat = live(*src, reqs[0])
                same = (max_err(s_img, l_img) / float(l_img.float().abs().max()),
                        max_err(s_lat, l_lat) / float(l_lat.float().abs().max()))
                results[tag]["same_process"] = same
                print(f"[serve] {tag}: in one process, served vs live on a request of "
                      f"{SERVE_BATCH}: image {same[0]:.3g}, latents {same[1]:.3g} of max")
                if tag == "float32":
                    need(max(same) <= SERVE_F32_EXACT, f"float32 served vs live in one "
                         f"process: {same} of max, limit {SERVE_F32_EXACT}")

                def rnd(fn):
                    t0 = time.perf_counter()
                    for tg in reqs:
                        fn(*src, tg)
                    torch.cuda.synchronize()
                    return 2 * SERVE_BATCH / (time.perf_counter() - t0)

                rates = {"live": [], "served": []}
                pair = [("live", live), ("served", prog)]
                for name, fn in pair:
                    rnd(fn)                                   # warm-up
                # in turns, the first of each pair alternating; the garbage
                # collector held off during the window (both sides alike)
                gc.collect()
                gc.disable()
                t_start = time.perf_counter()
                while (min(len(v) for v in rates.values()) < SERVE_MIN_ROUNDS
                       or time.perf_counter() - t_start < 2 * SERVE_WINDOW_S):
                    for name, fn in pair:
                        rates[name].append(rnd(fn))
                    pair.reverse()
                gc.enable()
                med = {k: statistics.median(v) for k, v in rates.items()}
                results[tag].update(fps_live=med["live"], fps_served=med["served"],
                                    rounds=len(rates["live"]),
                                    fps_range={k: (min(v), max(v)) for k, v in rates.items()})
                print(f"[serve] {tag}: frames/s on requests of {SERVE_BATCH} (median of "
                      f"{len(rates['live'])} rounds each, in turns): served {med['served']:.2f}"
                      f" ({min(rates['served']):.2f}-{max(rates['served']):.2f}), live "
                      f"{med['live']:.2f} ({min(rates['live']):.2f}-{max(rates['live']):.2f}), "
                      f"ratio {med['served'] / med['live']:.4f} on {smi}")
                need(med["served"] >= 0.95 * med["live"],
                     f"{tag}: served {med['served']:.2f} frames/s under 0.95x live "
                     f"{med['live']:.2f}")
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, results


# [heads]: the model heads off the serving path, card against CPU
HEADS_BATCH = 4                         # D and the W+ encoder; the 3D landmarks' frames
HEADS_CPU_FRAMES = 2                    # of the 562x1000 frames, held against the CPU
HEADS_RTOL, HEADS_ATOL = 1e-3, 1e-4     # float32 card vs CPU, atol relative to max


def capture_kernel_calls(fn):
    """Run ``fn()`` recording the K1 and K2 operator calls it makes:
    ([(x, taps, taps_shape, up, pad)], [(x, bias, slope, scale)]), inputs
    cloned."""
    from stylegan_directions_face_reenactment_tpu_torch.ops import fused_act, upfirdn2d_kernel
    k1s, k2s = [], []
    k1, k2 = upfirdn2d_kernel.upfirdn2d_op, fused_act.fused_bias_act_op

    def rec1(x, taps, shape, up, pad):
        k1s.append((x.detach().clone(), taps, shape, up, pad))
        return k1(x, taps, shape, up, pad)

    def rec2(x, bias, slope, scale):
        k2s.append((x.detach().clone(), None if bias is None else bias.detach().clone(),
                    slope, scale))
        return k2(x, bias, slope, scale)

    with mock.patch.object(upfirdn2d_kernel, "upfirdn2d_op", rec1), \
            mock.patch.object(fused_act, "fused_bias_act_op", rec2):
        fn()
    return k1s, k2s


def hold_captured(tag, k1s, k2s):
    """Each captured K1 and K2 call's kernel against its plain version on
    the same input (these launches are not the path's)."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
        fused_bias_act_cuda, fused_leaky_relu_plain)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
        upfirdn2d_cuda, upfirdn2d_plain)
    worst, shapes = {"K1": 0.0, "K2": 0.0}, set()
    for x, taps, shape, up, pad in k1s:
        k = torch.tensor(taps).reshape(shape)
        worst["K1"] = max(worst["K1"], max_err(upfirdn2d_cuda(x, (tuple(taps), tuple(shape)),
                                                              up, tuple(pad)),
                                               upfirdn2d_plain(x, k, up=up, pad=tuple(pad))))
        shapes.add(("K1", tuple(x.shape), tuple(pad)))
    for x, b, slope, scale in k2s:
        worst["K2"] = max(worst["K2"], max_err(fused_bias_act_cuda(x, b, slope, scale),
                                               fused_leaky_relu_plain(x, b, slope, scale)))
        shapes.add(("K2", tuple(x.shape)))
    need(worst["K1"] <= F32_TOL and worst["K2"] <= F32_TOL,
         f"[heads] {tag}: a kernel disagrees with its plain version: {worst}")
    return worst, len(shapes)


def phase_heads(smi):
    """[heads]: each head off the serving path on the card against the CPU
    on the same weights (float32, TF32 off): ``Discriminator(256,
    channel_multiplier=2)`` and ``WPlusEncoder(256)`` at B = 4, with every K1
    (the downsampling blurs at pads (2, 2) and (1, 1)) and K2 call they make
    (rank 4 and the final linear's rank 2) held against the plain versions;
    the two pSp heads at 256; ``estimate_landmarks_3d`` with the full
    ResNetDepth (3, 8, 36, 3) on 4 frames of 562x1000 (S3FD gated on
    content, so the kept face lies on each frame's patch); PTI's
    ``space_regularizer_loss`` at B = 1 and its backward. Returns the
    launches of those runs (a Counter)."""
    from stylegan_directions_face_reenactment_tpu_torch.losses.pti import (
        PTIHyperparams, space_regularizer_loss)
    from stylegan_directions_face_reenactment_tpu_torch.models.e4e import (
        BackboneEncoderUsingLastLayerIntoW, GradualStyleEncoder)
    from stylegan_directions_face_reenactment_tpu_torch.models.face.landmarks import (
        estimate_landmarks_3d)
    from stylegan_directions_face_reenactment_tpu_torch.models.face.fan import predict_depth
    from stylegan_directions_face_reenactment_tpu_torch.models.stylegan2 import (
        generator_forward, mapping)
    from stylegan_directions_face_reenactment_tpu_torch.weights import (
        init_discriminator, init_e4e, init_fan, init_generator, init_lpips,
        init_resnet_depth, init_s3fd, init_wplus_encoder)

    launches = Counter()

    def run(tag, fn, want_counts=None):
        """fn() on the card with the counts from 0, synchronized; its
        launches added to ``launches``; returns (output, seconds, counts)."""
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = dict(zip(("K1", "K2", "K3"), read_counts()))
        got.update(zip(("K1-bwd", "K1-bwd down 2", "K2-bwd"), read_bwd_counts()))
        if want_counts is not None:
            need(all(got[k] == v for k, v in want_counts.items()),
                 f"[heads] {tag}: launches {got}, want {want_counts}")
        launches.update({k: v for k, v in got.items() if k != "K1-bwd down 2"})
        return out, dt, got

    def held(tag, card, cpu, rtol=HEADS_RTOL, atol=HEADS_ATOL):
        card, cpu = card.detach().float().cpu(), cpu.detach().float()
        err = max_err(card, cpu) / float(cpu.abs().max())
        need(bool(torch.isfinite(card).all()) and allclose_scaled(card, cpu, rtol, atol),
             f"[heads] {tag}: card vs CPU max err {err:.3g} of max (rtol {rtol}, atol "
             f"{atol}*max)")
        return err

    gen = torch.Generator().manual_seed(40)
    x = (torch.rand(HEADS_BATCH, SIZE, SIZE, 3, generator=gen) * 2 - 1)
    report = []
    # (a) the discriminator and the W+ encoder
    for name, make, want in (
            ("Discriminator(256, channel_multiplier=2)",
             lambda dev: init_discriminator(41, SIZE, 2, device=dev), {"K1": 12, "K2": 15}),
            ("WPlusEncoder(256)", lambda dev: init_wplus_encoder(42, SIZE, device=dev),
             {"K1": 12, "K2": 13})):
        m, mc = make(None), make("cpu")
        with torch.no_grad():
            out, dt, _ = run(name, lambda: m(x.cuda()), want)
            k1s, k2s = capture_kernel_calls(lambda: m(x.cuda()))
            worst, n_shapes = hold_captured(name, k1s, k2s)
            err = held(name, out, mc(x))
        report.append(f"{name} {tuple(out.shape)}: {dt * 1e3:.2f} ms (first call), card vs "
                      f"CPU {err:.3g} of max; K1 {want['K1']} / K2 {want['K2']} launches, "
                      f"{n_shapes} kernel shapes held against the plain versions (max err "
                      f"K1 {worst['K1']:.3g}, K2 {worst['K2']:.3g})")
    # (b) the pSp heads at 256 (e4e's trunk, residual branches damped as slice 3's)
    xp = x[:1]
    for name, cls in (("GradualStyleEncoder", GradualStyleEncoder),
                      ("BackboneEncoderUsingLastLayerIntoW", BackboneEncoderUsingLastLayerIntoW)):
        mc = init_e4e(43, SIZE, device="cpu", cls=cls)
        with torch.no_grad():
            for blk in mc.body:
                blk.res_layer[4].weight.mul_(E4E_BN2_SCALE)
        m = copy.deepcopy(mc).cuda()
        with torch.no_grad():
            out, dt, _ = run(name, lambda: m(xp.cuda()))
            err = held(name, out, mc(xp), 1e-4, 1e-4)
        report.append(f"{name} {tuple(out.shape)}: {dt * 1e3:.2f} ms, card vs CPU {err:.3g} "
                      f"of max")
    # (c) the 3D landmarks on 562x1000 frames with a textured patch each
    sfd, fan, depth = init_s3fd(5, device="cpu"), init_fan(6, 4, device="cpu"), \
        init_resnet_depth(44, device="cpu")
    gate_s3fd_on_content(sfd)
    randomize_bn(fan, 45)
    randomize_bn(depth, 46)
    frames = torch.from_numpy(np.stack([patch_frame(100 + 60 * i, 150 + 180 * i, 47 + i)
                                        for i in range(HEADS_BATCH)])).float()
    nets = [copy.deepcopy(n).cuda() for n in (sfd, fan, depth)]
    with torch.no_grad():
        (lm, ok), dt, got = run("estimate_landmarks_3d",
                                lambda: estimate_landmarks_3d(*nets, frames.cuda()),
                                {"K3": K3_PER_PASS})
        lm_cpu, ok_cpu = estimate_landmarks_3d(sfd, fan, depth, frames[:HEADS_CPU_FRAMES])
        need(tuple(lm.shape) == (HEADS_BATCH, 68, 3) and bool(ok.all())
             and bool(torch.isfinite(lm).all()),
             f"[heads] estimate_landmarks_3d: {tuple(lm.shape)}, ok {ok.tolist()}")
        need(torch.equal(ok[:HEADS_CPU_FRAMES].cpu(), ok_cpu), "[heads] 3D: ok masks differ")
        xy = lm[:HEADS_CPU_FRAMES, :, :2].cpu()
        same = float((xy == lm_cpu[..., :2]).float().mean())
        need(same >= 0.9 and float((xy - lm_cpu[..., :2]).abs().max()) <= 8.0,
             f"[heads] 3D: {same:.3f} of the landmark coordinates equal the CPU's")
        # the depth net on the same inputs
        rs = np.random.RandomState(48)
        crops = torch.from_numpy(rs.rand(2, 256, 256, 3).astype(np.float32))
        pts = torch.from_numpy(rs.uniform(1, 64, (2, 68, 2)).astype(np.float32))
        scale = torch.tensor([1.2, 0.8])
        d_card = predict_depth(nets[2], crops.cuda(), pts.cuda(), scale.cuda())
        err_d = held("predict_depth", d_card, predict_depth(depth, crops, pts, scale))
        err_z = mean_rel(lm[:HEADS_CPU_FRAMES, :, 2].cpu(), lm_cpu[..., 2])
        need(err_z < 1e-2, f"[heads] 3D depths card vs CPU mean rel {err_z:.3g}")
    report.append(f"estimate_landmarks_3d (ResNetDepth (3, 8, 36, 3)) on {HEADS_BATCH} "
                  f"frames of {FRAME_HW[0]}x{FRAME_HW[1]}: {dt * 1e3:.2f} ms (first call), K3 "
                  f"{got['K3']} launches; frames 0-{HEADS_CPU_FRAMES - 1} vs CPU: {same:.4f} of "
                  f"the xy equal, depth mean rel {err_z:.3g}; predict_depth on the same inputs "
                  f"{err_d:.3g} of max")
    # (d) PTI's space regulariser at B = 1 and its backward
    g0c = init_generator(0, SIZE, 512, 8, CM, device="cpu")
    g1c = copy.deepcopy(g0c)
    with torch.no_grad():
        for p in g1c.parameters():
            p.mul_(1 + 0.05 * torch.randn(p.shape, generator=gen))
    lpc = init_lpips(8, device="cpu")
    with torch.no_grad():
        w = mapping(g0c, torch.randn(1, 512, generator=gen))
    hp = PTIHyperparams(latent_ball_num_of_samples=1)

    def fwd(g, code):
        return generator_forward(g, [code], input_is_latent=True)[0]

    g0, g1, lp = (copy.deepcopy(m).cuda() for m in (g0c, g1c, lpc))
    loss, dt, got = run("space_regularizer_loss", lambda: space_regularizer_loss(
        fwd, g1, g0, lp, w.cuda(), torch.Generator().manual_seed(49), hp).backward() or None)
    loss = space_regularizer_loss(fwd, g1, g0, lp, w.cuda(), torch.Generator().manual_seed(49),
                                  hp)
    loss_cpu = space_regularizer_loss(fwd, g1c, g0c, lpc, w,
                                      torch.Generator().manual_seed(49), hp)
    rel = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
    need(rel <= 1e-4 and got["K1"] == 2 * K1_PER_REQUEST and got["K2-bwd"] > 0,
         f"[heads] space_regularizer_loss: card {float(loss):.7g} vs CPU "
         f"{float(loss_cpu):.7g} (rel {rel:.3g}); launches {got}")
    report.append(f"space_regularizer_loss at B = 1: {float(loss):.7g} vs CPU "
                  f"{float(loss_cpu):.7g} (rel {rel:.3g}), with its backward {dt * 1e3:.2f} ms; "
                  f"launches {got}")
    for line in report:
        print(f"[heads] {line} on {smi}")
    return launches


K4_BATCH = BATCH                        # a StyleGAN3-T chunk's frames
# K4 against its plain version, relative to max(1, max|plain|): float32, the
# kernel sums each 1-D pass in the plain version's tap order, cuDNN's
# depthwise passes may not (two chained FIRs of up to 24 taps); bf16, both
# sum in float32 from the same bf16 input and round once. A misplaced tile,
# halo or phase moves outputs by about their own size.
K4_F32_TOL, K4_BF16_TOL = 2e-5, 1e-2
K4_CHUNK_TOL = 2e-4                     # a chunk with K4 vs with the plain version, of max
K4_PLAIN_SLICE = 4                      # frames a plain call at parity (its planes are 4x)
# (up, down, taps of fu, taps of fd) that run the kernel's instantiations
# zero-padded to 24 taps: every (up, down) pair at counts no published layer
# has, 24 taps included; (name, planes, in size, pad) of each
K4_GENERIC = (((1, 1, 5, 7), 5, 37, (3, 2, 3, 2)), ((1, 2, 3, 12), 6, 45, (5, 6, 5, 6)),
              ((2, 1, 12, 5), 7, 29, (7, 6, 7, 6)), ((2, 2, 8, 24), 5, 41, (12, 11, 12, 11)),
              ((4, 1, 24, 3), 6, 23, (13, 12, 13, 12)),
              ((4, 2, 16, 10), 7, 33, (14, 11, -3, 9)))


def k4_layers():
    """(name, layer) of the published StyleGAN3-T (``configs/models_config.py``'s
    ``ffhq_sg3t``), built on the CPU for its schedule alone."""
    from stylegan_directions_face_reenactment_tpu_torch.models import stylegan3 as sg3
    g = sg3.Generator()
    return list(zip(g.layer_names, g.layers()))


def k4_args(m, idx):
    """The K4 arguments of layer ``m`` (the ``idx``-th) after its input:
    (fu, fd, up, down, pad, gain, slope, clamp), the ToRGB's linear call
    with the output scale folded in."""
    if m.is_torgb:
        return m.up_taps, m.down_taps, m.up, m.down, m.padding, 0.25, 1.0, 64.0
    return m.up_taps, m.down_taps, m.up, m.down, m.padding, 2 ** 0.5, 0.2, 256.0


def k4_inputs(m, idx, dtype, gen, batch=K4_BATCH, channels=None):
    """(x, bias, scales) of layer ``m`` at ``batch``: the conv output of the
    layer (its input size padded by the kernel; ``channels`` of them, the
    published count unless given, the planes past it zero with a zero bias,
    as the synthesis pads them), three times unit normal so that the clamp
    bites; per-plane scales on every other layer (the demodulation and the
    next layer's styles)."""
    hw = m.in_size + m.conv_kernel - 1
    c = m.out_channels if channels is None else channels
    x = (3 * torch.randn(batch, c, hw, hw, generator=gen, device="cuda")).to(dtype)
    b = torch.randn(c, generator=gen, device="cuda")
    x[:, m.out_channels:] = 0
    b[m.out_channels:] = 0
    scales = {} if idx % 2 else dict(
        in_scale=torch.rand(batch, c, generator=gen, device="cuda") + 0.5,
        out_scale=torch.rand(batch, c, generator=gen, device="cuda") + 0.5)
    return x, b, scales


def k4_work(shape, ku, kd, up, down, pad, itemsize):
    """(FLOPs, bytes) of one K4 call: 2 × the polyphase FIR FMAs (the x and
    y passes of the upsampling at ku / up taps a sample, of the downsampling
    at kd taps; no zero-stuffed tap counted), the input read once and the
    output written once."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.filtered_lrelu import output_shape
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import normalize_pad
    n, c, h, w = shape
    px0, px1, py0, py1 = normalize_pad(pad)
    h1, w1 = h * up + py0 + py1 - ku + 1, w * up + px0 + px1 - ku + 1
    oh, ow = output_shape(h, w, ku, kd, up, down, pad)
    fmas = (h * w1 + h1 * w1) * ku / up + (h1 * ow + oh * ow) * kd
    return 2.0 * n * c * fmas, float(n * c * (h * w + oh * ow) * itemsize + 4 * c)


def k4_plain_sliced(x, args, b, scales):
    """The plain version, K4_PLAIN_SLICE frames a call (its upsampled plane
    of a chunk at L10 is 23.7 GB)."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.filtered_lrelu import (
        filtered_lrelu_plain)
    fu, fd, up, down, pad, gain, slope, clamp = args
    out = []
    for i in range(0, x.shape[0], K4_PLAIN_SLICE):
        s = {k: v[i:i + K4_PLAIN_SLICE] for k, v in scales.items()}
        out.append(filtered_lrelu_plain(x[i:i + K4_PLAIN_SLICE], fu, fd, b, up, down, pad,
                                        gain, slope, clamp, **s))
    return torch.cat(out)


def k4_parity():
    """K4 against its plain version at every published layer shape at a
    chunk of K4_BATCH, float32 and bf16, at the published channel counts
    and at the padded ones the synthesis runs (the pad planes zero, and
    zero out), and each generic instantiation at a small shape; K4 on the
    same values channels-last bit-equal to K4 on NCHW at each; returns the
    largest float32 error."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.filtered_lrelu import (
        filtered_lrelu_cuda, filtered_lrelu_plain, instantiated_taps, is_nhwc)
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0

    def held(label, got, want, dtype):
        nonlocal worst
        torch.cuda.synchronize()
        err = max_err(got, want)
        scale = max(1.0, float(want.float().abs().max()))
        lim = (K4_F32_TOL if dtype == torch.float32 else K4_BF16_TOL) * scale
        print(f"[k4] parity {label} {str(dtype)[6:]}: max abs err {err:.3g} (limit "
              f"{lim:.3g}; max|plain| {scale:.3g})")
        need(got.shape == want.shape and got.dtype == dtype and err <= lim,
             f"filtered_lrelu {label} {dtype} disagrees with its plain version")
        if dtype == torch.float32:
            worst = max(worst, err)

    def same_in_nhwc(label, x, got, *args, **scales):
        nhwc = filtered_lrelu_cuda(x.contiguous(memory_format=torch.channels_last), *args,
                                   **scales)
        torch.cuda.synchronize()
        need(is_nhwc(nhwc) and torch.equal(nhwc, got),
             f"filtered_lrelu {label} on channels-last differs from NCHW")

    for dtype in (torch.float32, torch.bfloat16):
        for idx, (name, m) in enumerate(k4_layers()):
            for channels in sorted({m.out_channels, m.out_padded}):
                x, b, scales = k4_inputs(m, idx, dtype, gen, channels=channels)
                args = k4_args(m, idx)
                got = filtered_lrelu_cuda(x, args[0], args[1], b, *args[2:], **scales)
                label = f"{name} {tuple(x.shape)} -> {tuple(got.shape)}"
                held(label, got, k4_plain_sliced(x, args, b, scales), dtype)
                same_in_nhwc(label, x, got, args[0], args[1], b, *args[2:], **scales)
                need(not got[:, m.out_channels:].any(),
                     f"filtered_lrelu {label} {dtype}: a zero pad plane came out nonzero")
                del x, got
                torch.cuda.empty_cache()
        for (up, down, ku, kd), planes, hw, pad in K4_GENERIC:
            need(instantiated_taps(up, down, ku, kd) == (24 // up, 24),
                 f"({up}, {down}, {ku}, {kd}) does not take the generic instantiation")
            x = (3 * torch.randn(1, planes, hw, hw + 3, generator=gen, device="cuda")).to(dtype)
            fu = torch.rand(ku, generator=gen, device="cuda").cpu() + 0.1
            fd = torch.rand(kd, generator=gen, device="cuda").cpu() + 0.1
            b = torch.randn(planes, generator=gen, device="cuda")
            scales = dict(in_scale=torch.rand(1, planes, generator=gen, device="cuda") + 0.5,
                          out_scale=torch.rand(1, planes, generator=gen, device="cuda") + 0.5)
            args = (fu / fu.sum(), fd / fd.sum(), b, up, down, pad, 2 ** 0.5, 0.2, 4.0)
            got = filtered_lrelu_cuda(x, *args, **scales)
            label = f"generic up {up} down {down} taps {ku}/{kd} {tuple(x.shape)}"
            held(f"{label} -> {tuple(got.shape)}", got, filtered_lrelu_plain(x, *args, **scales),
                 dtype)
            same_in_nhwc(label, x, got, *args, **scales)
    print("[k4] channels-last: bit-equal to NCHW at every shape above, both dtypes; the pad "
          "planes zero")
    return worst


def k4_timing(card_name):
    """Sums over the 15 K4 calls of a chunk of K4_BATCH (TF32 off), in each
    layout: channels-last at the channel counts the synthesis pads to (its
    path; key ``filtered_lrelu``), and NCHW at the published counts (key
    ``filtered_lrelu_nchw``): the kernel's device ms, host µs and call ms
    (as phase 4's), the plain version's ms (one pass over the NCHW chunk,
    K4_PLAIN_SLICE frames a call, after warm-ups), the bound (of the
    planes each layout's tensors hold)."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.filtered_lrelu import (
        _taps, filtered_lrelu_cuda, normalize_pad, plan_for)
    bw, flops, _ = card_rates(card_name)
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        sums = {key: {"library_ms": None} for key in ("filtered_lrelu", "filtered_lrelu_nchw")}
        for idx, (name, m) in enumerate(k4_layers()):
            fu, fd, up, down, pad, gain, slope, clamp = k4_args(m, idx)
            plain = None
            for key, layout, channels in (
                    ("filtered_lrelu_nchw", torch.contiguous_format, m.out_channels),
                    ("filtered_lrelu", torch.channels_last, m.out_padded)):
                x, b, scales = k4_inputs(m, idx, dtype, gen, channels=channels)
                if plain is None:
                    plain = time_ms(lambda: k4_plain_sliced(
                        x, (fu, fd, up, down, pad, gain, slope, clamp), b, scales), reps=1)
                    torch.cuda.empty_cache()
                x = x.contiguous(memory_format=layout)
                ops, nbytes = k4_work(tuple(x.shape), len(fu or (1,)), len(fd or (1,)), up,
                                      down, pad, x.element_size())
                bound = 1e3 * max(nbytes / bw, ops / flops)

                def call():
                    return filtered_lrelu_cuda(x, fu, fd, b, up, down, pad, gain, slope, clamp,
                                               **scales)

                ms, host, call_ms = three_times(call)
                p = plan_for(x, _taps(fu), _taps(fd), up, down, normalize_pad(pad), gain,
                             slope, clamp).params
                print(f"[k4] timing {name} {tuple(x.shape)} {tag} "
                      f"{'NHWC' if p.nhwc else 'NCHW'} (tile {p.th}, {p.gx * p.gy} tiles, "
                      f"groups of {p.cg}, {p.pz} planes a block, {p.gz} blocks a tile, "
                      f"{p.smem_bytes} B shared): kernel device {ms:.4f} ms, host {host:.2f} "
                      f"us, call {call_ms:.4f} ms; plain {plain:.3f} ms; bound {bound:.4f} ms "
                      f"({ops / 1e12:.4f} TFLOP, {nbytes / 1e9:.3f} GB); kernel/bound "
                      f"{ms / bound:.2f}")
                add(sums[key], ms=ms, host_us=host, call_ms=call_ms, plain_ms=plain,
                    bound_ms=bound, bytes=nbytes, ops=ops)
                del x
                torch.cuda.empty_cache()
        for key, t in sums.items():
            out[(key, tag)] = t
            layout = "NCHW" if key.endswith("nchw") else "channels-last"
            print_sums(f"[k4] filtered_lrelu per chunk of {K4_BATCH} frames, {layout}, {tag}",
                       t, bw)
    return out


def k4_chunk():
    """One StyleGAN3-T chunk of K4_BATCH 256² crops through ``make_reenact_fn``
    at the published widths (seeded generator, A on 8 of 16 rows, DECA),
    float32: K4's launches and plan misses zeroed before a second chunk and
    read after it (one call a layer, no plan made anew), and its images
    against the same latents synthesized with the plain version in K4's
    place (each of the 15 substitutions counted, and the largest difference
    between K4 and the plain version at any of them printed). Returns the
    launches."""
    from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
    from stylegan_directions_face_reenactment_tpu_torch.models import stylegan3 as sg3
    from stylegan_directions_face_reenactment_tpu_torch.models.deca import calculate_shapemodel
    from stylegan_directions_face_reenactment_tpu_torch.ops import filtered_lrelu as k4
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
        generate_image, make_reenact_fn)
    from stylegan_directions_face_reenactment_tpu_torch.weights import (
        init_deca, init_direction_matrix)
    from stylegan_directions_face_reenactment_tpu_torch.weights.stylegan3 import init_stylegan3
    g = init_stylegan3(0, device="cuda")
    a = init_direction_matrix(1, 512, 15, w_plus=True, num_layers=8, device="cuda")
    deca = init_deca(2, device="cuda")
    need(g.n_latent == 16 and len(g.layer_names) == 15, "not the published StyleGAN3-T")
    with torch.inference_mode():
        trunc = sg3.mean_latent(g, torch.Generator().manual_seed(3), 4096)
        z = torch.randn(1, 512, generator=torch.Generator().manual_seed(4)).cuda()
        code = sg3.style_to_wplus(g, [sg3.mapping(g, z)])
        src = generate_image(g, code, input_is_latent=True)
        params, angles = calculate_shapemodel(deca, src)
    crops = torch.rand(K4_BATCH, 256, 256, 3, generator=torch.Generator().manual_seed(5)) * 2 - 1
    fn = make_reenact_fn(g, a, deca, initialize_directions("ffhq", 15, 6.0), truncation=0.7,
                         truncation_latent=trunc, num_layers_shift=8)
    fn(code, params, angles, crops)
    torch.cuda.synchronize()
    k4.filtered_lrelu_cuda.launches = k4.filtered_lrelu_cuda.plan_misses = 0
    k4.filtered_lrelu_cuda.prefetched_planes = k4.filtered_lrelu_cuda.nhwc_launches = 0
    plans, plan_for = [], k4.plan_for

    def recorded(*args):
        plans.append(plan_for(*args))
        return plans[-1]

    t0 = time.perf_counter()
    with mock.patch.object(k4, "plan_for", recorded):
        img, lat = fn(code, params, angles, crops)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, misses = k4.filtered_lrelu_cuda.launches, k4.filtered_lrelu_cuda.plan_misses
    prefetched = k4.filtered_lrelu_cuda.prefetched_planes
    nhwc = k4.filtered_lrelu_cuda.nhwc_launches
    need(launches == 15 == nhwc and misses == 0,
         f"a StyleGAN3-T chunk launched K4 {launches} times ({nhwc} channels-last) with "
         f"{misses} plans made; expected 15 (15) and 0")
    # blocks × (planes walked − 1), from each launch's plan
    want = sum(q.params.gx * q.params.gy * (q.params.planes - q.params.gz) for q in plans)
    need(prefetched == want > 0,
         f"K4 counted {prefetched} prefetched planes in the chunk; its plans give {want}")
    need(tuple(img.shape) == (K4_BATCH, 256, 256, 3) and bool(torch.isfinite(img).all()),
         f"the StyleGAN3-T chunk's images: {tuple(img.shape)}, finite "
         f"{bool(torch.isfinite(img).all())}")
    substituted = []

    def plain_k4(x, fu, fd, b, up, down, pad, gain, slope, clamp, in_scale=None,
                 out_scale=None):
        scales = {k: v for k, v in (("in_scale", in_scale), ("out_scale", out_scale))
                  if v is not None}
        out = k4_plain_sliced(x, (fu, fd, up, down, pad, gain, slope, clamp), b, scales)
        # K4 on the same input, to show the substitution changes something
        k4_out = k4.filtered_lrelu(x, fu, fd, b, up, down, pad, gain, slope, clamp, **scales)
        substituted.append(max_err(k4_out, out))
        return out

    # the whole chunk at once: StyleGAN3 normalises the styles over the batch
    with torch.inference_mode(), mock.patch.object(sg3, "filtered_lrelu", plain_k4):
        want = generate_image(g, lat, input_is_latent=True)
    need(len(substituted) == 15,
         f"the plain version stood in for K4 {len(substituted)} times in a chunk, not 15")
    err, lim = max_err(img, want), K4_CHUNK_TOL * float(want.abs().max())
    print(f"[k4] a StyleGAN3-T chunk of {K4_BATCH} crops (make_reenact_fn, float32): K4 "
          f"launches {launches} ({nhwc} channels-last), plans made {misses}, planes "
          f"prefetched {prefetched}; "
          f"{wall * 1e3:.1f} ms; images vs the plain "
          f"version's synthesis of its latents (15 calls in K4's place; K4 vs plain on "
          f"their inputs at most {max(substituted):.3g}): max abs err {err:.3g} (limit "
          f"{lim:.3g})")
    need(err <= lim, "the StyleGAN3-T chunk's images disagree with the plain version's")
    del g, a, deca, fn
    torch.cuda.empty_cache()
    return launches


def phase_k4(card_name):
    """21. [k4]: K4 (``sdfr::filtered_lrelu``) against its plain version at
    every published StyleGAN3-T layer shape at a chunk, in float32 and bf16,
    and every generic (zero-padded) instantiation; its launches in a chunk
    of the reenactment path; its times and bound. Returns (worst float32
    error, timing sums, launches)."""
    t0 = time.perf_counter()
    worst = k4_parity()
    timing = k4_timing(card_name)
    launches = k4_chunk()
    print(f"[k4] {time.perf_counter() - t0:.1f} s")
    return worst, timing, launches


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
    try:
        cli, cli_launches = phase_cli(smi)
        edit, edit_launches = phase_edit(smi)
        invert, invert_launches = phase_invert(smi)
        # after the CLI phases, so that their readings keep their first conditions
        worst["fused_conv_block_bwd"], timing[("fused_conv_block_bwd", "float32")] = (
            phase_k3_bwd(name))
        grad_launches = phase_grad()
        flame_ms = phase_flame()
        train, train_launches = phase_train(smi)   # on the CLI phase's files
        # after [train], so that every earlier phase reads as it was recorded
        ddp_launches, ddp_a, ddp_b = phase_ddp(smi, os.path.join(CLI_DIR, "train_vox"))
        mesh_launches, mesh_fps = phase_mesh(smi)
        stats_launches, stats_sps, stats_wall = phase_stats(smi)
        report_launches, report_wall = phase_report(smi, os.path.join(CLI_DIR, "targets"))
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    # slice 9, after every earlier phase, so that theirs read as they were recorded
    serve_launches, serve = phase_serve(smi)
    heads_launches = phase_heads(smi)
    phase_render(smi)      # the renderer, after them, for the same reason
    # K4 last, so that every earlier phase reads as it was recorded
    worst["filtered_lrelu"], k4_timing_sums, k4_launches = phase_k4(name)
    timing.update(k4_timing_sums)
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
    for tag, r in cli.items():
        print(f"[result] CLI run ({tag}): wall {r['wall_s']:.3f} s, target loop "
              f"{r['target_fps']:.2f} frames/s over {r['frames']} frames"
              + (f", video write {r['video_s']:.3f} s" if "video_s" in r else "")
              + f" on {smi}")
    print(f"[result] FLAME decode at B = {FLAME_BATCH}: {flame_ms:.3f} ms; editing sweep "
          f"{edit['sweep_ips']:.2f} images/s; editing walls "
          + ", ".join(f"({k}) {edit[k]['wall_s']:.3f} s" for k in "abc")
          + f"; inversion {invert['ips']:.2f} images/s, CLI wall {invert['wall_s']:.3f} s "
          f"on {smi}")
    for tag in ("synthetic", "synthetic bf16", "paired"):
        r = train[tag]
        print(f"[result] train step, {tag}, batch {TRAIN_BATCH}: {r['ms']:.3f} ms "
              f"({r['ms_min']:.3f}-{r['ms_max']:.3f}), peak {r['peak_bytes']} bytes on {smi}")
    print(f"[result] run_trainer walls: (a) synthetic {train['walls'][0]:.3f} s, (b) paired "
          f"{train['walls'][1]:.3f} s on {smi}")
    for label, ranks in (("(a) NCCL", ddp_a), ("(b) gloo, one card", ddp_b)):
        for r in ranks:
            print(f"[result] [ddp] {label} rank {r['rank']} of {r['world']}: paired step "
                  f"{r['step_ms']:.3f} ms at {r['rows']} rows, all-reduce {r['reduce_ms']:.4f}"
                  f" ms, peak {r['peak_bytes']} bytes on {smi}")
    print(f"[result] [mesh] " + ", ".join(f"{k} {v[0]:.2f} frames/s" for k, v in
                                          mesh_fps.items())
          + f"; [stats] {stats_sps:.2f} samples/s (main wall {stats_wall:.3f} s); [report] "
          f"wall {report_wall:.3f} s for {REPORT_FRAMES} frames on {smi}")
    for tag, r in serve.items():
        print(f"[result] [serve] {tag}: served {r['fps_served']:.2f} frames/s, live "
              f"{r['fps_live']:.2f} (median of {r['rounds']} rounds each); export "
              f"{r['export_s']:.3f} s, save {r['save_s']:.3f} s, load {r['load_s']:.3f} s, "
              f"bundle {r['bundle_bytes']} bytes on {smi}")
    apps = (cli_launches, edit_launches, invert_launches, train_launches,
            Counter(ddp_launches), Counter(mesh_launches), stats_launches, report_launches,
            Counter(dict(zip(("K1", "K2", "K3"), serve_launches))), heads_launches)
    launches = [launches[0] + launches2[0] + fwd3[0] + sum(c["K1"] for c in apps),
                launches[1] + launches2[1] + fwd3[1] + sum(c["K2"] for c in apps),
                launches2[2] + fwd3[2] + grad_launches["K3"] + sum(c["K3"] for c in apps),
                bwd3[0] + sum(c["K1-bwd"] for c in apps),
                bwd3[2] + sum(c["K2-bwd"] for c in apps),
                grad_launches["K3-bwd"] + sum(c["K3-bwd"] for c in apps)]
    launches.append(k4_launches)
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
             launches[2]),
            ("fused_conv_block_bwd", "cuda", f"{PORT}/ops/fused_conv_block.py",
             "stylegan_directions_face_reenactment_tpu/ops/fused_conv_block.py:187",
             launches[5]),
            # the JAX package has no StyleGAN3, so K4 replaces no TPU kernel
            ("filtered_lrelu", "cuda", f"{PORT}/csrc/filtered_lrelu.cu", None,
             launches[6])):
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


def main_only(names):
    """``python3 chip_smoke.py --only ddp [ddp_cards] [mesh] [stats]
    [report] [serve] [heads] [render] [k4]``: those phases alone, after the
    device, the build and, for slice 8's, the CLI and train inputs (``ddp_cards`` is
    [ddp]'s (a) and (c), the multi-card parts, for a machine with several
    cards). It prints no last line."""
    name, smi = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    phases = {"ddp": lambda: phase_ddp(smi, tree),
              "ddp_cards": lambda: phase_ddp(smi, tree, parts=("a", "c")),
              "mesh": lambda: phase_mesh(smi), "stats": lambda: phase_stats(smi),
              "report": lambda: phase_report(smi, os.path.join(CLI_DIR, "targets")),
              "serve": lambda: phase_serve(smi), "heads": lambda: phase_heads(smi),
              "render": lambda: phase_render(smi), "k4": lambda: phase_k4(name)}
    need(names and all(n in phases for n in names), f"--only takes phases of {list(phases)}")
    try:
        if set(names) - {"serve", "heads", "render", "k4"}:   # slice 8's read the CLI's files
            write_cli_inputs()
            tree = write_train_inputs()
        for n in names:
            t0 = time.perf_counter()
            phases[n]()
            print(f"[only] {n}: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--only"]:
            main_only(sys.argv[2:])
        else:
            main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
