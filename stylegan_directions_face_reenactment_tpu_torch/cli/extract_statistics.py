"""Measure the direction ranges over synthetic faces (the reference's
``extract_statistics.py``; the JAX package's ``cli/extract_statistics.py``):
generate N random faces, run DECA, record each dimension's min and max of
[yaw, pitch, roll, jaw, 50 expressions] → ``ranges_{dataset}.npy`` of shape
(54, 2), float64, the ranges that Δp scaling reads for a new generator.

Usage:
  python -m stylegan_directions_face_reenactment_tpu_torch.cli.extract_statistics \\
      --output_path ./ --num_samples 2000 [--random_init] [--device cpu]

The flags are the JAX package's, plus ``--device``: the CUDA card by
default (it raises without one), or the CPU. The faces go through in
batches of ``--batch_size`` (:func:`batch_rows`). The z's are drawn with
``torch.randn`` from a CPU ``torch.Generator`` seeded with ``--seed`` and
then moved to the device, so the card and the CPU see the same draws; they
are not the JAX package's ``jax.random`` numbers, so the two packages'
files from one seed hold different samples.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Extract direction range statistics")
    p.add_argument("--output_path", default="./")
    p.add_argument("--dataset_type", default="voxceleb")
    p.add_argument("--image_resolution", type=int, default=None,
                   help="override the dataset's generator resolution "
                        "(small sizes for CPU smoke runs)")
    p.add_argument("--num_samples", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--truncation", type=float, default=0.7)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--deca_alignment", default="fan",
                   choices=["fan", "fan_frame", "resize"],
                   help="DECA preprocessing: 'fan' = reference SFD-crop→FAN "
                        "warp, 'fan_frame' = FAN on the full frame, "
                        "'resize' = plain bilinear")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the nets run: the CUDA card (it raises without one) "
                        "or the CPU")
    return p


def filter_detected_rows(all_rows: np.ndarray) -> np.ndarray:
    """Drop detection-failure rows before the min/max reduction.

    With the 'fan' alignment, samples whose SFD detection misses the
    confidence gate carry the -180° sentinel in yaw/pitch/roll and zeroed
    coefficients (`estimate_DECA.py:48-51` semantics). One such row would
    make the angle mins -180 and silently corrupt the direction scaling
    built from this file. (The reference's extract_statistics.py shares
    this failure mode unfiltered — known deviation, see README.)
    """
    detected = ~np.all(all_rows[:, :3] == -180.0, axis=1)
    if not detected.all():
        print(f"dropping {int((~detected).sum())}/{len(all_rows)} samples "
              "with failed face detection")
        all_rows = all_rows[detected]
    if len(all_rows) == 0:
        raise RuntimeError("face detection failed on every sample; ranges "
                           "would be meaningless (random-init models?)")
    return all_rows


def batch_rows(g, deca, z: torch.Tensor, *, truncation: float,
               truncation_latent: Optional[torch.Tensor], fan=None, s3fd=None) -> torch.Tensor:
    """One batch's (B, 54) rows: yaw, pitch, roll, jaw, exp_0..exp_49 of
    the generator's faces of ``z`` (B, 512), aligned as
    ``pipeline/reenactment.py::align_for(fan, s3fd)`` says."""
    from ..models.deca.deca import calculate_shapemodel
    from ..pipeline.reenactment import align_for
    from ..pipeline.synthesis import generate_image
    with torch.no_grad():
        imgs = generate_image(g, z, truncation=truncation, truncation_latent=truncation_latent)
        params, angles = calculate_shapemodel(deca, imgs, align_fn=align_for(fan, s3fd))
        return torch.cat([angles, params["pose"][:, 3:4], params["alpha_exp"]], dim=1)


def main(argv=None):
    """Run the CLI; returns the (54, 2) ranges it saved."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else args.device)

    from .model_loading import compute_trunc, load_deca, load_face_models, load_generator

    kw = dict(random_init=args.random_init, device=dev)
    g = load_generator(args.dataset_type, resolution=args.image_resolution, **kw)
    deca = load_deca(**kw)
    trunc = compute_trunc(g)
    fan = sfd = None
    if args.deca_alignment in ("fan", "fan_frame"):
        sfd, fan = load_face_models(**kw)
        if args.deca_alignment == "fan_frame":
            sfd = None

    gen = torch.Generator().manual_seed(args.seed)
    rows = []
    n_batches = -(-args.num_samples // args.batch_size)
    for i in range(n_batches):
        z = torch.randn((args.batch_size, 512), generator=gen).to(dev)
        rows.append(batch_rows(g, deca, z, truncation=args.truncation, truncation_latent=trunc,
                               fan=fan, s3fd=sfd).cpu().numpy())
        if (i + 1) % 10 == 0:
            print(f"{(i + 1) * args.batch_size}/{args.num_samples}")
    all_rows = filter_detected_rows(np.concatenate(rows)[:args.num_samples])

    ranges = np.stack([all_rows.min(axis=0), all_rows.max(axis=0)],
                      axis=1).astype(np.float64)  # (54, 2)
    os.makedirs(args.output_path, exist_ok=True)
    out = os.path.join(args.output_path, f"ranges_{args.dataset_type}.npy")
    np.save(out, ranges)
    print(f"saved {out} shape {ranges.shape}")
    return ranges


if __name__ == "__main__":
    main()
