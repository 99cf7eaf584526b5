"""Quality-parity harness: the CSIM / pose / expression 1% gate (the JAX
package's ``cli/parity_report.py``).

One command turns checkpoints into a pass/fail parity report (the
``BASELINE.md`` north star: CSIM, pose error and expression error within 1%
of the PyTorch reference). It runs self-reenactment (source = the first
target frame, the protocol of the reference's video evaluation,
``libs/utilities/utils_train.py:810-883``), or cross-reenactment with an
explicit ``--source_path``, over a target video or folder, computes the
three evaluation metrics as ``utils_train.py:695-732`` does, and writes
``PARITY_REPORT.json`` with the JAX package's keys.

Gating: ``--reference_metrics ref.json`` (``{"csim": .., "pose": ..,
"exp": ..}`` measured by running the PyTorch reference on the same inputs)
gives the report a verdict at ``--tolerance`` (default 1%): CSIM may not be
more than tol worse (better always passes); pose and exp may not be more
than tol·reference higher. With ``--random_init`` the harness still runs
end to end and labels the report unverified.

Usage:
  REENACT_PRETRAINED_ROOT=~/downloads python -m \\
      stylegan_directions_face_reenactment_tpu_torch.cli.parity_report \\
      --target_path video.mp4 --output_path ./report [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given (it raises when
there is no card).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CSIM/pose/exp parity report")
    p.add_argument("--target_path", required=True,
                   help="target pose source: image, folder, or video")
    p.add_argument("--source_path", default=None,
                   help="source identity image; default = first target "
                        "frame (self-reenactment)")
    p.add_argument("--output_path", required=True)
    p.add_argument("--dataset_type", default="voxceleb")
    p.add_argument("--image_resolution", type=int, default=None)
    p.add_argument("--frame_batch", type=int, default=16)
    p.add_argument("--video_stride", type=int, default=1)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--optimize_generator", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="PTI fine-tune on the source first (reference "
                        "inference default, `run_inference.py:309`)")
    p.add_argument("--random_init", action="store_true",
                   help="random-init all models: smoke-runs the harness "
                        "without checkpoints; report is labeled unverified")
    p.add_argument("--deca_alignment", default="fan",
                   choices=["fan", "fan_frame", "resize"])
    p.add_argument("--skip_preprocess", action="store_true",
                   help="inputs are already FFHQ-cropped 256 faces")
    p.add_argument("--device_crop", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="FFHQ crop on the device (--no-device_crop = the "
                        "host crop)")
    p.add_argument("--detect_width", type=int, default=None,
                   help="pre-detection rescale width (default: the "
                        "reference's 1000; 0 = native frame size)")
    p.add_argument("--reuse_landmarks", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="single-detection pipeline (see run_inference): "
                        "with real checkpoints this harness then QUANTIFIES "
                        "the deviation — compare the report against a "
                        "default-pipeline run on the same inputs")
    p.add_argument("--batch0_only", action="store_true",
                   help="replicate the reference's quirky eval semantics "
                        "bit-faithfully: pose/expression errors read only "
                        "index [0] of each batch (`utils_train.py:695-708`) "
                        "while CSIM still runs on the whole batch (`:729`). "
                        "Use when gating against metrics produced by the "
                        "reference's own evaluation loop")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of the REENACT program under test "
                        "(the CLI's --compute_dtype); the metric programs "
                        "(DECA re-encode, ArcFace, pose/exp) always run "
                        "f32 so a bf16 run quantifies serving-dtype drift "
                        "against the same measuring stick")
    p.add_argument("--reference_metrics", default=None,
                   help="JSON file with the PyTorch reference's "
                        "{csim, pose, exp} on the same inputs; enables the "
                        "pass/fail gate")
    p.add_argument("--tolerance", type=float, default=0.01,
                   help="relative gate width (default 1%%)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the nets run: the CUDA card (it raises without one) "
                        "or the CPU")
    return p


def _gate(ours: dict, ref: dict, tol: float) -> dict:
    """Within-tolerance verdict; 'better than reference' always passes
    (higher CSIM, lower pose/exp error)."""
    eps = 1e-8
    d_csim = (ref["csim"] - ours["csim"]) / max(abs(ref["csim"]), eps)
    d_pose = (ours["pose_error_deg"] - ref["pose"]) / max(abs(ref["pose"]), eps)
    d_exp = (ours["expression_error"] - ref["exp"]) / max(abs(ref["exp"]), eps)
    checks = {
        "csim": {"reference": ref["csim"], "ours": ours["csim"],
                 "rel_shortfall": d_csim, "pass": bool(d_csim <= tol)},
        "pose": {"reference": ref["pose"], "ours": ours["pose_error_deg"],
                 "rel_excess": d_pose, "pass": bool(d_pose <= tol)},
        "exp": {"reference": ref["exp"], "ours": ours["expression_error"],
                "rel_excess": d_exp, "pass": bool(d_exp <= tol)},
    }
    return {"tolerance": tol, "checks": checks,
            "pass": bool(all(c["pass"] for c in checks.values()))}


def frame_metrics(spec, deca, idb, reenacted: torch.Tensor, p_t, a_t,
                  source: torch.Tensor, fan=None, s3fd=None):
    """The per-frame metric program (``utils_train.py:695-732``): the
    reenacted frames' DECA coefficients, aligned as ``align_for(fan, s3fd)``
    says, against the targets' (``p_t``, ``a_t``), and their ArcFace
    embedding against the source's. Returns (CSIM (T,), pose error (T,),
    expression error (T,), valid (T,)): a frame is valid where neither
    side carries the −180° sentinel of a failed detection."""
    from ..losses.id_loss import extract_id_feats
    from ..models.deca.deca import calculate_shapemodel
    from ..models.nn import resize_bilinear
    from ..pipeline.reenactment import align_for
    from ..train.eval import expression_error, pose_error
    with torch.no_grad():
        reenacted = reenacted.float()
        p_s, a_s = calculate_shapemodel(deca, reenacted, align_fn=align_for(fan, s3fd))
        # ArcFace's fixed face crop (x[:, 35:223, 32:220]) is defined on 256
        # images; the resize covers sub-256 test-scale generators only
        re256 = (reenacted if reenacted.shape[1] == source.shape[1] else
                 resize_bilinear(reenacted.permute(0, 3, 1, 2), source.shape[1:3])
                 .permute(0, 2, 3, 1))
        f_src = extract_id_feats(idb, source)
        f_re = extract_id_feats(idb, re256)
        csim_pf = torch.sum(f_src * f_re, dim=-1)
        valid = (a_s != -180.0).any(dim=-1) & (a_t != -180.0).any(dim=-1)
        return csim_pf, pose_error(a_s, a_t), expression_error(spec, p_s, p_t), valid


def main(argv=None):
    """Run the CLI; returns the report it wrote."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else args.device)
    os.makedirs(args.output_path, exist_ok=True)

    from ..geometry import initialize_directions
    from ..pipeline import make_prep_fn, make_reenact_fn, pad_batch, setup_source
    from ..utils.image_utils import load_image
    from .model_loading import (compute_trunc, load_deca, load_direction_matrix, load_e4e,
                                load_face_models, load_generator, load_id_backbone,
                                load_lpips)
    from .run_inference import _load_target_frames

    # --- models -----------------------------------------------------------
    kw = dict(random_init=args.random_init, device=dev)
    g = load_generator(args.dataset_type, resolution=args.image_resolution, **kw)
    e4e = load_e4e(args.dataset_type, resolution=args.image_resolution, **kw)
    a = load_direction_matrix(args.dataset_type, **kw)
    deca = load_deca(**kw)
    idb = load_id_backbone(**kw)
    need_fan = args.deca_alignment in ("fan", "fan_frame")
    sfd = fan = None
    if not args.skip_preprocess or need_fan:
        sfd, fan = load_face_models(**kw)
    fan_deca = fan if need_fan else None
    sfd_deca = sfd if args.deca_alignment == "fan" else None
    spec = initialize_directions(args.dataset_type, 15, 6.0)
    trunc = compute_trunc(g)

    # the FFHQ crop is 256 whatever the generator's size; only the
    # synthesis emits the generator's size
    if args.reuse_landmarks and (args.skip_preprocess or args.deca_alignment == "resize"):
        raise ValueError("--reuse_landmarks needs the detection prep and a "
                         "bbox-based --deca_alignment (fan/fan_frame)")
    prep = make_prep_fn(sfd, fan, skip_preprocess=args.skip_preprocess,
                        device_crop=args.device_crop, return_landmarks=args.reuse_landmarks,
                        detect_width=args.detect_width, device=dev)

    # --- frames -----------------------------------------------------------
    frames = _load_target_frames(args.target_path, args.video_stride)
    if args.max_frames:
        frames = frames[:args.max_frames]
    self_reenactment = args.source_path is None
    src_raw = [frames[0]] if self_reenactment else [load_image(args.source_path)]

    lp = load_lpips(**kw) if args.optimize_generator else None
    source_img, source_code, g_src, params_source, angles_source = setup_source(
        g, e4e, deca, src_raw, prep, truncation_latent=trunc,
        optimize_generator=args.optimize_generator, lpips_params=lp,
        fan_params=fan_deca, s3fd_params=sfd_deca, device=dev)

    # return_target_params: the reenactment computes the target
    # coefficients anyway; the metric loop reuses them
    reenact = make_reenact_fn(
        g_src, a, deca, spec, truncation=0.7, truncation_latent=trunc, fan_params=fan_deca,
        s3fd_params=sfd_deca,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32,
        return_target_params=True, reuse_landmarks=args.reuse_landmarks, device=dev)

    bi = args.frame_batch
    csims, poses, exps, used, dropped = [], [], [], 0, 0
    for s in range(0, len(frames), bi):
        chunk = frames[s:s + bi]
        res = prep(chunk)
        tgt_batch, ok = res[0], np.asarray(res[1])
        pad = bi - len(chunk)
        extra = (pad_batch(res[2], pad), pad_batch(ok, pad)) if args.reuse_landmarks else ()
        reenacted, _, p_t, a_t = reenact(source_code, params_source, angles_source,
                                         pad_batch(tgt_batch, pad), *extra)
        c, p, e, valid = (t.cpu().numpy() for t in frame_metrics(
            spec, deca, idb, reenacted, p_t, a_t, source_img, fan=fan_deca, s3fd=sfd_deca))
        n = len(chunk)
        # drop frames with no detected face: at preprocessing (ok) or in the
        # DECA re-detections (valid, the -180° sentinel)
        keep = ok[:n] & valid[:n]
        csims.append(c[:n][keep])
        if args.batch0_only:
            # the reference's evaluation: pose/exp from batch index [0] only
            # (`utils_train.py:695-708`); CSIM stays whole-batch (`:729`)
            b0 = keep.copy()
            b0[1:] = False
            poses.append(p[:n][b0])
            exps.append(e[:n][b0])
        else:
            poses.append(p[:n][keep])
            exps.append(e[:n][keep])
        used += int(keep.sum())
        dropped += n - int(keep.sum())
        print(f"{min(s + bi, len(frames))}/{len(frames)} frames")

    if used == 0:
        raise RuntimeError("no target frame with a detected face")
    csims, poses, exps = np.concatenate(csims), np.concatenate(poses), np.concatenate(exps)
    if poses.size == 0:
        raise RuntimeError("batch0_only: no chunk had a detected face at "
                           "batch index [0]")
    metrics = {"csim": float(csims.mean()),
               "pose_error_deg": float(poses.mean()),
               "expression_error": float(exps.mean())}
    report = {
        "metrics": metrics,
        "per_frame_std": {"csim": float(csims.std()),
                          "pose_error_deg": float(poses.std()),
                          "expression_error": float(exps.std())},
        "n_frames": used,
        "n_frames_dropped_no_detection": dropped,
        "self_reenactment": self_reenactment,
        "optimize_generator": bool(args.optimize_generator),
        "deca_alignment": args.deca_alignment,
        "reuse_landmarks": bool(args.reuse_landmarks),
        "compute_dtype": args.compute_dtype,
        "batch0_only": bool(args.batch0_only),
        "checkpoints": "random_init" if args.random_init else "real",
        "verified": not args.random_init,
        "gate": None,
    }
    if args.random_init:
        report["note"] = ("models are randomly initialized: metrics are NOT "
                          "meaningful; this run only validates the harness")
    if args.reference_metrics:
        with open(args.reference_metrics) as f:
            ref = json.load(f)
        report["gate"] = _gate(metrics, ref, args.tolerance)

    out = os.path.join(args.output_path, "PARITY_REPORT.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report["metrics"]))
    if report["gate"] is not None:
        print("gate:", "PASS" if report["gate"]["pass"] else "FAIL")
    print(f"saved {out}")
    return report


if __name__ == "__main__":
    main()
