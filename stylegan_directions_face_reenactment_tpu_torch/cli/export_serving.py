"""Export a serving bundle of the reenactment program (the JAX package's
``cli/export_serving.py``).

Writes the whole per-frame program (DECA alignment → encode → Δp → A →
StyleGAN2 synthesis), exported with ``torch.export``, and its weights into
a directory that a server loads with ``serving.load_reenact_bundle``: no
model-building code, checkpoint conversion or tracing on the serving host.
The program is traced on the platform it is for (``--platforms cuda``, the
default, needs the card; ``--platforms cpu``), and a bundle is for that one
platform.

Usage:
  python -m stylegan_directions_face_reenactment_tpu_torch.cli.export_serving \\
      --output_path ./bundle --dataset_type voxceleb --frame_batch 16
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a reenactment serving bundle "
                                            "(torch.export)")
    p.add_argument("--output_path", required=True, help="bundle directory to write")
    p.add_argument("--dataset_type", default="voxceleb")
    p.add_argument("--image_resolution", type=int, default=None,
                   help="override the dataset's generator resolution")
    p.add_argument("--frame_batch", type=int, default=16,
                   help="frames a call of the exported program (serving pads and "
                        "chunks requests of any length to this)")
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--deca_alignment", default="fan", choices=["fan", "fan_frame", "resize"])
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="the program's compute dtype")
    p.add_argument("--platforms", nargs="+", default=None,
                   help="the one platform the bundle is for: cuda (the default) or cpu")
    p.add_argument("--reuse_landmarks", action=argparse.BooleanOptionalAction, default=False,
                   help="export the single-detection variant (takes preprocessing "
                        "landmarks + ok mask as extra inputs)")
    p.add_argument("--return_target_params", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="program also returns the target DECA coefficients (for metric "
                        "consumers)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch
    from ..geometry import initialize_directions
    from ..serving import _one_platform, export_reenact, save_reenact_bundle
    from .model_loading import (compute_trunc, load_deca, load_direction_matrix,
                                load_face_models, load_generator)

    if args.reuse_landmarks and args.deca_alignment == "resize":
        raise ValueError("--reuse_landmarks needs a bbox-based --deca_alignment "
                         "(fan/fan_frame)")
    platform = _one_platform(args.platforms)

    kw = dict(random_init=args.random_init, device=platform)
    g = load_generator(args.dataset_type, resolution=args.image_resolution, **kw)
    a = load_direction_matrix(args.dataset_type, **kw)
    deca = load_deca(**kw)
    sfd = fan = None
    if args.deca_alignment in ("fan", "fan_frame"):
        sfd, fan = load_face_models(**kw)
    spec = initialize_directions(args.dataset_type, 15, 6.0)
    trunc = compute_trunc(g)

    dtype = torch.float32 if args.compute_dtype == "float32" else torch.bfloat16
    exported, weights, meta = export_reenact(
        g, a, deca, spec, frame_batch=args.frame_batch, truncation=0.7,
        truncation_latent=trunc, compute_dtype=dtype, fan_params=fan,
        s3fd_params=sfd if args.deca_alignment == "fan" else None,
        return_target_params=args.return_target_params,
        reuse_landmarks=args.reuse_landmarks, platforms=(platform,))
    meta["dataset_type"] = args.dataset_type
    save_reenact_bundle(args.output_path, exported, weights, meta)
    print(f"wrote serving bundle to {args.output_path} "
          f"(platforms={meta['platforms']}, frame_batch={meta['frame_batch']}, "
          f"generator {meta['generator_size']}px, "
          f"alignment {meta['deca_alignment']}, {meta['compute_dtype']})")


if __name__ == "__main__":
    main()
