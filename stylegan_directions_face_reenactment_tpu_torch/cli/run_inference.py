"""Face reenactment inference (the reference's ``run_inference.py``; the JAX
package's ``cli/run_inference.py``).

Self- or cross-reenactment: invert the source face, PTI-tune the generator
on it unless told not to, then transfer each target frame's pose and
expression, in batches of target frames. Runs on the CUDA card unless
``--device cpu`` is given, and raises when there is no card.

Usage:
  python -m stylegan_directions_face_reenactment_tpu_torch.cli.run_inference \\
      --source_path img.png --target_path video.mp4 --output_path ./out

Writes ``{idx:06d}.png`` (``--save_images``, the reenacted frame at the
generator's resolution), ``grids/{idx:06d}.png`` (``--save_grid``,
[source | target crop | reenacted] rows) and ``generated_video.mp4``
(``--save_video``; written with OpenCV, ``native/imgproc.py``).
``--n_devices N`` splits every batch of target frames over cards 0..N-1
(N slots of the CPU with ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..geometry import initialize_directions
from ..models.face.cropping import crop_using_landmarks_batch
from ..native.imgproc import extract_frames, from_gan_range, generate_video
from ..parallel.mesh import make_mesh
from ..pipeline import (CROP_SIZE, make_fused_reenact_fn, make_prep_fn, make_reenact_fn,
                        pad_batch, setup_source, to_gan_range)
from ..pipeline.preprocess import DETECT_WIDTH, resize_width
from ..utils.common import get_image_files
from ..utils.device import resolve_device
from ..utils.image_utils import (generate_grid_image, grid_row, load_image, save_image,
                                 save_u8, tensor_to_image)
from . import model_loading

PREFETCH = 3   # target chunks uploaded ahead of the one the card runs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Neural face reenactment")
    p.add_argument("--source_path", required=True,
                   help="source identity: .png/.jpg/.mp4")
    p.add_argument("--target_path", required=True,
                   help="target pose source: image, folder, or video")
    p.add_argument("--output_path", required=True)
    p.add_argument("--optimize_generator", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="PTI fine-tune of the generator on the source (on by "
                        "default, as in the reference; --no-optimize_generator "
                        "turns it off)")
    p.add_argument("--save_images", action=argparse.BooleanOptionalAction, default=False,
                   help="write each reenacted frame at the generator's resolution")
    p.add_argument("--save_grid", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--save_video", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--video_content", default="grid", choices=["grid", "reenact"],
                   help="what --save_video writes: 'grid' = the reference's "
                        "[source|target|reenacted] rows (`utils_inference.py:20-33`); "
                        "'reenact' = the reenacted frames alone, which leaves the "
                        "crops on the card")
    p.add_argument("--dataset_type", default="voxceleb")
    p.add_argument("--image_resolution", type=int, default=None,
                   help="the generator's resolution (default: the registry's, 256 "
                        "voxceleb / 1024 ffhq)")
    p.add_argument("--frame_batch", type=int, default=16,
                   help="target frames per device batch")
    p.add_argument("--video_stride", type=int, default=1)
    p.add_argument("--random_init", action="store_true",
                   help="seeded random weights instead of the checkpoint files")
    p.add_argument("--deca_alignment", default="fan", choices=["fan", "fan_frame", "resize"],
                   help="DECA preprocessing: 'fan' = the reference's SFD-detect → crop → "
                        "FAN → bbox → similarity warp to 224 "
                        "(decalib/datasets/detectors.py:23-42, datasets.py:57-86); "
                        "'fan_frame' = FAN on the whole 256 crop; 'resize' = bilinear")
    p.add_argument("--n_devices", type=int, default=None,
                   help="cards to split each target batch over (frame data parallelism in "
                        "one process, parallel/mesh.py); must divide --frame_batch")
    p.add_argument("--skip_preprocess", action="store_true",
                   help="inputs are FFHQ-cropped faces already: no detection or "
                        "landmark crop, a bilinear resize to 256")
    p.add_argument("--device_crop", action=argparse.BooleanOptionalAction, default=True,
                   help="cut the FFHQ crop on the device, within 1 intensity unit of "
                        "the host crop; boxes that leave the frame take the host "
                        "crop. --no-device_crop takes the host crop for every frame")
    p.add_argument("--detect_width", type=int, default=None,
                   help="rescale frames to this width before detection (default: the "
                        "reference's 1000, `utils_inference.py:67`; 0 = detect at the "
                        "frame's own size)")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype of the per-frame program (synthesis, the "
                        "detection and alignment nets, the DECA trunk; coefficients "
                        "stay float32)")
    p.add_argument("--reuse_landmarks", action=argparse.BooleanOptionalAction, default=False,
                   help="one detection a frame: feed the preprocessing landmarks, mapped "
                        "into the crop, to the DECA kpt68 box instead of a second SFD + "
                        "FAN pass on the crop (the reference detects twice). Needs "
                        "detection prep and --deca_alignment fan/fan_frame")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the nets run: the CUDA card (it raises without one) "
                        "or the CPU")
    return p


def effective_frame_batch(frame_batch: int, generator_size: int,
                          n_devices: int = 1) -> int:
    """The JAX package's batch guard at generator size 1024: a batch of 3-7
    is rounded up to 8 (to a multiple of ``n_devices`` too), because its
    TPU build compiles those batches badly. Whether the card needs it was
    never measured. Chunks shorter than the batch are padded anyway, so
    this changes the padding, never the frames delivered."""
    if generator_size >= 1024 and 2 < frame_batch < 8:
        fb = 8
        if n_devices > 1:
            fb = ((fb + n_devices - 1) // n_devices) * n_devices
        return fb
    return frame_batch


def _download(outs, dev: torch.device):
    """Start the device→host copies of a chunk's outputs: pinned buffers
    written by non-blocking copies, and the CUDA event after them (None on
    the CPU, where the outputs are the buffers)."""
    if dev.type != "cuda":
        return list(outs), None
    bufs = []
    for o in outs:
        buf = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
        buf.copy_(o, non_blocking=True)
        bufs.append(buf)
    done = torch.cuda.Event()
    done.record()
    return bufs, done


def _run_targets_fused(args, resized, reenact_fused, source_img, source_code,
                       params_source, angles_source, make_fallback, dev,
                       need_crops, stats):
    """The fused target loop: raw frames at the detection width go up as
    uint8, one device call a chunk (detect → crop → reenact,
    ``pipeline/reenactment.py::reenact_raw_batch``), and uint8 frames come
    down: the reenacted frames at the generator's resolution, with the
    crops when a grid is wanted. Uploads run ``PREFETCH`` chunks ahead on
    two threads (pinned buffers, non-blocking copies); a chunk's download
    starts as soon as its call is issued, and the host work for chunk i
    (files, the rare out-of-frame fallback) runs while the card computes
    chunk i+1. Frames whose FFHQ box leaves the frame are cut again by the
    host crop and run through ``make_fallback()``'s unfused program.

    The [source | crop | reenacted] row is composed here by ``grid_row``,
    as the unfused loop composes it, so ``--save_images`` writes the
    generator-resolution frame in both video modes. Returns the frames for
    the video; ``stats`` gains the counts and the host seconds spent
    waiting for the card, in the fallback and writing files, and inside the
    program's calls (which return once the chunk's work is queued)."""
    bi = args.frame_batch
    chunks = [resized[s:s + bi] for s in range(0, len(resized), bi)]
    src_cell = tensor_to_image(source_img)
    stats.update(no_face=0, fallback_frames=0, fallback_calls=0, call_s=0.0, wait_s=0.0,
                 fallback_s=0.0, write_s=0.0)

    def upload(chunk):
        arr = np.stack(chunk).astype(np.uint8)
        t = torch.from_numpy(pad_batch(arr, bi - len(chunk)))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        return t

    frames_out = []
    fallback = None
    idx = 0

    def process(chunk, bufs, done):
        nonlocal fallback, idx
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        t1 = time.perf_counter()
        stats["wait_s"] += t1 - t0
        n = len(chunk)
        arrs = [b.numpy() for b in bufs]
        reen_u8 = arrs[0][:n]
        crops_u8 = arrs[1][:n] if need_crops else None
        ok, in_frame, pts = (a[:n] for a in arrs[-3:])
        stats["no_face"] += int((~ok).sum())
        bad = np.nonzero(ok & ~in_frame)[0]
        if bad.size:
            if fallback is None:
                fallback = make_fallback()
            crops_f, reen_f, ok_f = fallback([chunk[i] for i in bad], pts[bad])
            for j, i in enumerate(bad):
                if ok_f[j]:
                    if crops_u8 is not None:
                        crops_u8[i] = crops_f[j]
                    reen_u8[i] = reen_f[j]
            stats["fallback_frames"] += int(bad.size)
            stats["fallback_calls"] += 1
        t2 = time.perf_counter()
        stats["fallback_s"] += t2 - t1
        for j in range(n):
            if args.save_images:
                save_u8(reen_u8[j], os.path.join(args.output_path, f"{idx:06d}.png"))
            if args.save_grid or args.save_video:
                if need_crops:
                    frame = grid_row(src_cell, crops_u8[j], reen_u8[j])
                else:
                    frame = reen_u8[j]
                if args.save_grid:
                    save_u8(frame, os.path.join(args.output_path, "grids", f"{idx:06d}.png"))
                if args.save_video:
                    frames_out.append(frame)
            idx += 1
        stats["write_s"] += time.perf_counter() - t2

    with ThreadPoolExecutor(2) as pool:
        futs = {i: pool.submit(upload, chunks[i]) for i in range(min(PREFETCH, len(chunks)))}
        pending = None
        for ci, chunk in enumerate(chunks):
            frames_dev = futs.pop(ci).result()
            if ci + PREFETCH < len(chunks):
                futs[ci + PREFETCH] = pool.submit(upload, chunks[ci + PREFETCH])
            t0 = time.perf_counter()
            outs = reenact_fused(source_code, params_source, angles_source, frames_dev)
            stats["call_s"] += time.perf_counter() - t0
            outs = (outs[0], outs[2]) + tuple(outs[3:]) if need_crops else tuple(outs)
            if pending is not None:
                process(*pending)
            pending = (chunk,) + _download(outs, dev)
        if pending is not None:
            process(*pending)
    if stats["no_face"]:
        print(f"warning: no face detected in {stats['no_face']} target frame(s)")
    if stats["fallback_frames"]:
        print(f"host crop for {stats['fallback_frames']} target frame(s) whose FFHQ box "
              "left the frame")
    return frames_out


def _load_target_frames(path: str, stride: int):
    if os.path.isdir(path):
        files = get_image_files(path)
        if not files:
            raise FileNotFoundError(f"no images in {path}")
        return [load_image(f) for f in files]
    ext = path.rsplit(".", 1)[-1].lower()
    if ext in ("png", "jpg", "jpeg"):
        return [load_image(path)]
    if ext in ("mp4", "avi"):
        return extract_frames(path, stride=stride)
    raise ValueError(f"unsupported target path: {path}")


def main(argv=None):
    """Run the CLI. Returns what the run counted: target frames, whether
    the fused loop ran, the target loop's seconds and, of them, the host
    seconds of its parts (the loops' ``stats``); on the fused loop also
    frames without a face and frames (and chunks) that took the host-crop
    fallback; with a video, the seconds its write took after the loop
    (``video_s``)."""
    args = build_parser().parse_args(argv)
    if args.reuse_landmarks and (args.skip_preprocess or args.deca_alignment == "resize"):
        raise ValueError("--reuse_landmarks needs the detection prep and a bbox-based "
                         "--deca_alignment (fan/fan_frame)")
    dev = resolve_device(None if args.device == "cuda" else args.device)
    # frame data parallelism (parallel/mesh.py), checked before any work:
    # divisibility against the user's --frame_batch first, so that the error
    # names the value they set; the 1024 guard below keeps it divisible
    n_dev = args.n_devices or 1
    mesh = None
    if n_dev > 1:
        if args.frame_batch % n_dev:
            raise ValueError("--n_devices must divide --frame_batch")
        mesh = make_mesh(n_dev, device=dev if dev.type == "cpu" else None)
    if args.save_video:
        import cv2  # noqa: F401  (the video writer; fail before any work)
    os.makedirs(args.output_path, exist_ok=True)
    if args.save_grid:
        os.makedirs(os.path.join(args.output_path, "grids"), exist_ok=True)

    # --- models -----------------------------------------------------------
    kw = dict(random_init=args.random_init, device=dev)
    g = model_loading.load_generator(args.dataset_type, resolution=args.image_resolution, **kw)
    e4e = model_loading.load_e4e(args.dataset_type, resolution=args.image_resolution, **kw)
    a = model_loading.load_direction_matrix(args.dataset_type, **kw)
    deca = model_loading.load_deca(**kw)
    need_fan = args.deca_alignment in ("fan", "fan_frame")
    sfd = fan = None
    if not args.skip_preprocess or need_fan:
        sfd, fan = model_loading.load_face_models(**kw)
    fan_deca = fan if need_fan else None
    sfd_deca = sfd if args.deca_alignment == "fan" else None
    spec = initialize_directions(args.dataset_type, 15, 6.0)
    trunc = model_loading.compute_trunc(g)

    # the FFHQ crop is 256 whatever the generator's size: e4e and DECA take
    # it, only the synthesis emits the generator's size
    prep = make_prep_fn(sfd, fan, skip_preprocess=args.skip_preprocess,
                        device_crop=args.device_crop, return_landmarks=args.reuse_landmarks,
                        detect_width=args.detect_width, device=dev)

    # --- source -----------------------------------------------------------
    if args.source_path.rsplit(".", 1)[-1].lower() in ("mp4", "avi"):
        src_raw = [extract_frames(args.source_path, get_only_first=True)[0]]
    else:
        src_raw = [load_image(args.source_path)]
    lp = model_loading.load_lpips(**kw) if args.optimize_generator else None
    source_img, source_code, g_src, params_source, angles_source = setup_source(
        g, e4e, deca, src_raw, prep, truncation_latent=trunc,
        optimize_generator=args.optimize_generator, lpips_params=lp,
        fan_params=fan_deca, s3fd_params=sfd_deca, device=dev)

    # --- targets, batched -------------------------------------------------
    frames = _load_target_frames(args.target_path, args.video_stride)
    print(f"Run reenactment for {len(frames)} frames")
    fb = effective_frame_batch(args.frame_batch, g.size, n_dev)
    if fb != args.frame_batch:
        print(f"frame_batch {args.frame_batch} at generator size {g.size}: padding "
              f"batches to {fb}")
        args.frame_batch = fb
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    stats = {"frames": len(frames)}
    t0 = time.perf_counter()

    # the fused path (default): detect → crop → reenact in one call a chunk,
    # uint8 both ways
    use_fused = args.device_crop and not args.skip_preprocess
    if use_fused:
        dw = DETECT_WIDTH if args.detect_width is None else args.detect_width
        resized = [resize_width(np.asarray(f), dw) if dw else np.asarray(f) for f in frames]
        use_fused = len({im.shape for im in resized}) == 1   # mixed shapes: bucketed path
    stats["fused"] = use_fused
    if use_fused:
        need_crops = args.save_grid or (args.save_video and args.video_content == "grid")
        reenact_fused = make_fused_reenact_fn(
            g_src, a, deca, spec, sfd, fan, truncation=0.7, truncation_latent=trunc,
            fan_params=fan_deca, s3fd_params=sfd_deca, reuse_landmarks=args.reuse_landmarks,
            compute_dtype=compute_dtype, output_u8=True,
            outputs="full" if need_crops else "reenact", mesh=mesh, device=dev)

        def make_fallback():
            # the host crop (pad, blur and fade where the box leaves the
            # frame) and the unfused program with the full alignment
            reenact_host = make_reenact_fn(
                g_src, a, deca, spec, truncation=0.7, truncation_latent=trunc,
                fan_params=fan_deca, s3fd_params=sfd_deca, compute_dtype=compute_dtype,
                mesh=mesh, device=dev)

            def fallback(frames_list, lms):
                crops, cok = crop_using_landmarks_batch(frames_list, list(lms),
                                                        image_size=CROP_SIZE)
                tgt = pad_batch(to_gan_range(crops), args.frame_batch - len(frames_list))
                reen = reenact_host(source_code, params_source, angles_source, tgt)[0]
                return crops, from_gan_range(reen[:len(frames_list)].float().cpu()), cok

            return fallback

        frames_out = _run_targets_fused(args, resized, reenact_fused, source_img, source_code,
                                        params_source, angles_source, make_fallback, dev,
                                        need_crops=need_crops, stats=stats)
    else:
        frames_out = _run_targets_unfused(args, frames, prep, g_src, a, deca, spec, trunc,
                                          fan_deca, sfd_deca, compute_dtype, source_img,
                                          source_code, params_source, angles_source, dev,
                                          stats, mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    stats["target_s"] = time.perf_counter() - t0
    if args.save_video and frames_out:
        t0 = time.perf_counter()
        generate_video(frames_out, os.path.join(args.output_path, "generated_video.mp4"))
        stats["video_s"] = time.perf_counter() - t0
    print("done")
    return stats


def _run_targets_unfused(args, frames, prep, g_src, a, deca, spec, trunc, fan_deca, sfd_deca,
                         compute_dtype, source_img, source_code, params_source, angles_source,
                         dev, stats, mesh=None):
    """The unfused target loop: ``prep`` (detect, host or device crop) of
    chunk i+1 runs on a thread while chunk i is reenacted. Returns the
    frames for the video; ``stats`` gains the host seconds spent waiting
    for ``prep``, in the reenactment calls and writing files."""
    stats.update(prep_wait_s=0.0, reenact_s=0.0, write_s=0.0)
    reenact = make_reenact_fn(g_src, a, deca, spec, truncation=0.7, truncation_latent=trunc,
                              fan_params=fan_deca, s3fd_params=sfd_deca,
                              compute_dtype=compute_dtype,
                              reuse_landmarks=args.reuse_landmarks, mesh=mesh, device=dev)
    need_grid = args.save_grid or (args.save_video and args.video_content == "grid")
    bi = args.frame_batch
    chunks = [frames[s:s + bi] for s in range(0, len(frames), bi)]
    frames_out = []
    idx = 0
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(prep, chunks[0]) if chunks else None
        for ci, chunk in enumerate(chunks):
            t0 = time.perf_counter()
            res = fut.result()
            t1 = time.perf_counter()
            tgt_batch, ok = res[0], res[1]
            if ci + 1 < len(chunks):
                fut = pool.submit(prep, chunks[ci + 1])
            pad = bi - len(chunk)
            extra = (pad_batch(res[2], pad), pad_batch(ok, pad)) if args.reuse_landmarks else ()
            reenacted = reenact(source_code, params_source, angles_source,
                                pad_batch(tgt_batch, pad), *extra)[0]
            reenacted = reenacted[:len(chunk)].float().cpu().numpy()
            t2 = time.perf_counter()
            stats["prep_wait_s"] += t1 - t0
            stats["reenact_s"] += t2 - t1
            for j in range(len(chunk)):
                if args.save_images:
                    save_image(reenacted[j], os.path.join(args.output_path, f"{idx:06d}.png"))
                if need_grid:
                    grid = generate_grid_image(source_img.cpu().numpy(), tgt_batch[j:j + 1],
                                               reenacted[j:j + 1])
                    if args.save_grid:
                        save_u8(grid, os.path.join(args.output_path, "grids", f"{idx:06d}.png"))
                if args.save_video:
                    frames_out.append(grid if args.video_content == "grid"
                                      else tensor_to_image(reenacted[j]))
                idx += 1
            stats["write_s"] += time.perf_counter() - t2
    return frames_out


if __name__ == "__main__":
    main()
