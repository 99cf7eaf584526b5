#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA card and the CUDA
toolkit. It imports the port (``stylegan_directions_face_reenactment_tpu_torch``)
and nothing of JAX or the JAX package. Phases, in order; any failure exits
non-zero without printing the last line:

1. device: the card's name, count, power limit;
2. build: K1 (upfirdn2d) and K2 (fused bias-act) from ``csrc/`` with nvcc,
   with each kernel's registers and shared memory;
3. kernel parity: each kernel against its plain PyTorch version on the card
   at every shape the serving path gives it (voxceleb-256, a batch of 16),
   float32 and bf16, TF32 off;
4. kernel timing: CUDA events over many launches at those shapes, beside the
   plain version, one PyTorch library call computing the same function, and
   the least time the card could take;
5. the slice: random-init voxceleb-256 generator (channel multiplier 1, 8
   mapping layers), A (15 → 8·512) and DECA ResNet-50 at 224, served through
   ``make_reenact_fn`` for requests of 16, 16 and 5 frames in float32 and
   bf16; launch counts per request, output checks, frames 0-1 of the first
   request against the same weights on the CPU (float32 and bf16), the
   median frames/s over rounds of the three requests repeated for at least
   ``WINDOW_S`` seconds with its spread, and peak memory.

The last two lines are the kernels' numbers and ``{"ok": true, ...}``.
"""

import json
import statistics
import subprocess
import sys
import time

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
F32_TOL, BF16_TOL = 1e-5, 1e-2
REPS = 50
WINDOW_S, MIN_ROUNDS = 5.0, 10       # the slice's timed window, per dtype
# bf16, frames 0-1 of request 1, mean relative drift on an H100; readings
# vary between processes with the same seeds (card vs card float32 0.024-
# 0.057, card vs CPU bf16 image 0.019-0.042, latent 0.006-0.014), and the
# limits are about twice the largest
BF16_DRIFT, BF16_CPU_IMG, BF16_CPU_LAT = 0.1, 0.085, 0.028


class SmokeFailure(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_rates(name):
    """(memory bytes/s, float32 FLOP/s outside the tensor cores) of the card,
    from the published data sheets (SXM part unless the name says PCIe/NVL)."""
    if "H200" in name:
        return 4.8e12, 67e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    need(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps=REPS):
    """Mean ms per call on the card: CUDA events around ``reps`` calls after
    a warm-up."""
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
    k = make_kernel((1, 3, 3, 1), gain=4)
    worst = {"upfirdn2d": 0.0, "fused_bias_act": 0.0}
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
    return worst


def phase_timing(card_name):
    """Per-request sums over the serving path's shapes (TF32 off)."""
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import (
        fused_bias_act_cuda, fused_leaky_relu_plain)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d import (
        make_kernel, upfirdn2d, upfirdn2d_output_shape)
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import (
        upfirdn2d_cuda)
    bw, flops = card_rates(card_name)
    k = make_kernel((1, 3, 3, 1), gain=4)
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
             "bytes": 0, "ops": 0}
        for call, x in k1_inputs(dtype, gen):
            oh, ow = upfirdn2d_output_shape(x.shape[2], x.shape[3], (4, 4), up=call.up,
                                            pad=call.pad)
            n_out = x.shape[0] * x.shape[1] * oh * ow
            nbytes = (x.numel() + n_out) * x.element_size()
            ops = n_out * 2 * 16 // (call.up * call.up)   # taps that meet a sample
            bound = 1e3 * max(nbytes / bw, ops / flops)
            ms = time_ms(lambda: upfirdn2d_cuda(x, k, call.up, call.pad))
            plain = time_ms(lambda: upfirdn2d(x, k, up=call.up, pad=call.pad))
            lib = time_ms(library_k1(x, k, call))
            print(f"[timing] upfirdn2d {call.name} {tuple(x.shape)} {tag}: kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, bound "
                  f"{bound:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s)")
            t["ms"] += ms
            t["plain_ms"] += plain
            t["library_ms"] += lib
            t["bound_ms"] += bound
            t["bytes"] += nbytes
            t["ops"] += ops
        out[("upfirdn2d", tag)] = t
        t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0,
             "bytes": 0, "ops": 0}
        for shape, x, b in k2_inputs(dtype, gen):
            nbytes = 2 * x.numel() * x.element_size() + b.numel() * x.element_size()
            ops = 3 * x.numel()
            bound = 1e3 * max(nbytes / bw, ops / flops)
            ms = time_ms(lambda: fused_bias_act_cuda(x, b))
            plain = time_ms(lambda: fused_leaky_relu_plain(x, b))
            print(f"[timing] fused_bias_act {shape} {tag}: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {bound:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s)")
            t["ms"] += ms
            t["plain_ms"] += plain
            t["bound_ms"] += bound
            t["bytes"] += nbytes
            t["ops"] += ops
        out[("fused_bias_act", tag)] = t
    for (name, tag), t in out.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"[timing] {name} per request of {BATCH} frames, {tag}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library {lib}, "
              f"bound {t['bound_ms']:.4f} ms ({t['bytes'] / 1e9:.3f} GB over "
              f"{bw / 1e12:.2f} TB/s)")
    return out


def phase_slice():
    from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
    from stylegan_directions_face_reenactment_tpu_torch.models.deca import calculate_shapemodel
    from stylegan_directions_face_reenactment_tpu_torch.models.stylegan2 import (
        generator_forward, mapping, mean_latent, n_latent_for, style_to_wplus, synthesis)
    from stylegan_directions_face_reenactment_tpu_torch.ops.fused_act import fused_bias_act_cuda
    from stylegan_directions_face_reenactment_tpu_torch.ops.upfirdn2d_kernel import upfirdn2d_cuda
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import make_reenact_fn
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
            upfirdn2d_cuda.launches = 0
            fused_bias_act_cuda.launches = 0
            t0 = time.perf_counter()
            img, lat = fn(source_code, params_source, angles_source, tgt)
            torch.cuda.synchronize()
            busy += time.perf_counter() - t0
            k1, k2 = upfirdn2d_cuda.launches, fused_bias_act_cuda.launches
            need((k1, k2) == (K1_PER_REQUEST, K2_PER_REQUEST),
                 f"{tag} request {r}: K1/K2 launched {k1}/{k2} times, expected "
                 f"{K1_PER_REQUEST}/{K2_PER_REQUEST}")
            launches[0] += k1
            launches[1] += k2
            t = tgt.shape[0]
            need(tuple(img.shape) == (t, SIZE, SIZE, 3) and
                 tuple(lat.shape) == (t, n_lat, 512),
                 f"{tag} request {r}: shapes {tuple(img.shape)} {tuple(lat.shape)}")
            need(bool(torch.isfinite(img).all()) and bool(torch.isfinite(lat).all()),
                 f"{tag} request {r}: non-finite output")
            if r == 0 and keep_first:
                first[tag] = (img[:2].float().cpu(), lat[:2].float().cpu())
        return busy

    results, launches, first = {}, [0, 0], {}
    frames = sum(REQUESTS)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        fn = make_reenact_fn(g, a, deca, spec, truncation=0.7, truncation_latent=trunc,
                             compute_dtype=dtype)
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
    got_img, got_lat = first["float32"]
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
    # port and the JAX package do (tests/test_torch_reenact.py)
    bf_img, bf_lat = first["bfloat16"]
    drift = mean_rel(bf_img, got_img)
    cpu_drift = mean_rel(want["bfloat16"][0], want_img)
    img16 = mean_rel(bf_img, want["bfloat16"][0])
    lat16 = mean_rel(bf_lat, want["bfloat16"][1])
    print(f"[slice] bf16, frames 0-1 of request 1, mean relative drift: card vs card "
          f"float32 {drift:.4f} (limit {BF16_DRIFT}; CPU bf16 vs CPU float32 "
          f"{cpu_drift:.4f}); card vs CPU bf16: image "
          f"{img16:.4f} (limit {BF16_CPU_IMG}), latent {lat16:.4f} (limit "
          f"{BF16_CPU_LAT})")
    need(drift < BF16_DRIFT, "the bf16 path drifted from float32")
    need(img16 < BF16_CPU_IMG and lat16 < BF16_CPU_LAT,
         "the card's bf16 path disagrees with the CPU's")
    phase_breakdown(g, a, deca, spec, trunc,
                    (source_code, params_source, angles_source), targets[0])
    return results, launches


def _category(kernel_name):
    n = kernel_name.lower()
    if "upfirdn2d_kernel" in n:
        return "K1 upfirdn2d"
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
                ms = time_ms(fn, reps=10)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                extra = torch.cuda.max_memory_allocated() - base
                print(f"[breakdown] {tag} {name}, {t} frames: {ms:.3f} ms, extra peak "
                      f"memory {extra / 2**30:.3f} GiB")
        fn = make_reenact_fn(g, a, deca, spec, truncation=0.7, truncation_latent=trunc,
                             compute_dtype=dtype)
        fn(code, ps, angs, tgt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(code, ps, angs, tgt)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        per_cat, n_kernels, others = {}, 0, []
        for e in prof.key_averages():
            dev = getattr(e, "self_device_time_total", None)
            if dev is None:
                dev = getattr(e, "self_cuda_time_total", 0)
            # device-side events only: a CPU range (an aten op, an autograd
            # Function) is credited with the kernels it launched as well
            if dev > 0 and e.device_type == DeviceType.CUDA:
                cat = _category(e.key)
                per_cat[cat] = per_cat.get(cat, 0.0) + dev
                n_kernels += e.count
                if cat == "other":
                    others.append((dev, e.key))
        busy = sum(per_cat.values())
        print(f"[breakdown] {tag} one request of {t} frames under the profiler: wall "
              f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
              f"({100 * busy / wall_us:.1f} %, idle {100 - 100 * busy / wall_us:.1f} %), "
              f"{n_kernels} kernel launches")
        for cat, us in sorted(per_cat.items(), key=lambda kv: -kv[1]):
            print(f"[breakdown] {tag}   {cat}: {us / 1e3:.3f} ms "
                  f"({100 * us / max(busy, 1e-9):.1f} % of device time)")
        for us, key in sorted(others, reverse=True)[:4]:
            print(f"[breakdown] {tag}     other: {us / 1e3:.3f} ms {key[:100]}")


def main():
    name, smi = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[setup] TF32 off for cuDNN and matmul in every phase, timing included")
    phase_build()
    worst = phase_parity()
    timing = phase_timing(name)
    results, launches = phase_slice()
    for tag, r in results.items():
        print(f"[result] {tag}: {r['fps']:.2f} frames/s (median of {r['rounds']} rounds, "
              f"{r['fps_min']:.2f}-{r['fps_max']:.2f}), peak {r['peak_bytes']} bytes "
              f"on {smi}")

    kernels = []
    for name_k, route, source, replaces, n in (
            ("upfirdn2d", "cuda", f"{PORT}/csrc/upfirdn2d.cu",
             "stylegan_directions_face_reenactment_tpu/ops/pallas_upfirdn.py:256",
             launches[0]),
            ("fused_bias_act", "cuda", f"{PORT}/csrc/fused_bias_act.cu",
             "stylegan_directions_face_reenactment_tpu/ops/fused_act.py:92",
             launches[1])):
        t = timing[(name_k, "float32")]
        kernels.append({
            "name": name_k, "route": route, "source": source, "replaces": replaces,
            "launches": n, "max_abs_err": worst[name_k], "ms": t["ms"],
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
