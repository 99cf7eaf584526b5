"""Batch e4e inversion of a VoxCeleb tree (the reference's
``invert_images.py``; the JAX package's ``cli/invert_images.py``).

Walks ``<dataset>/<id>/<video>/frames_cropped/*.png``, inverts the frames
with e4e in batches, and writes ``inversion/frames/*.png`` (the
resynthesized frames) and ``inversion/latent_codes/*.npy`` (the W+ codes)
beside each video's frames: the on-disk cache the training datasets read.
Runs on the CUDA card unless ``--device cpu`` is given, and raises when
there is no card.

Usage:
  python -m stylegan_directions_face_reenactment_tpu_torch.cli.invert_images \\
      --dataset_path ./voxceleb --batch_size 4
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.datasets import DatasetInversion, Loader
from ..pipeline.inversion import make_invert_fn
from ..utils.device import resolve_device
from ..utils.image_utils import save_image
from . import model_loading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Invert a VoxCeleb dataset tree")
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--dataset_type", default="voxceleb")
    p.add_argument("--batch_size", type=int, default=4)
    # store_true with default True, as the reference's: always on
    p.add_argument("--save_images", action="store_true", default=True)
    p.add_argument("--random_init", action="store_true",
                   help="seeded random weights instead of the checkpoint files")
    p.add_argument("--image_resolution", type=int, default=None,
                   help="the generator's resolution (default: the registry's)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None):
    """Run the CLI. Returns the frames and batches it inverted."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else args.device)
    kw = dict(random_init=args.random_init, device=dev)
    g = model_loading.load_generator(args.dataset_type, resolution=args.image_resolution, **kw)
    e4e = model_loading.load_e4e(args.dataset_type, resolution=args.image_resolution, **kw)
    trunc = model_loading.compute_trunc(g)
    invert = make_invert_fn(e4e, g, truncation=0.7, truncation_latent=trunc, device=dev)

    dataset = DatasetInversion(args.dataset_path, image_size=g.size)
    loader = Loader(dataset, args.batch_size, shuffle=False, drop_last=False)
    print(f"Inverting {len(dataset)} frames from {args.dataset_path}")
    batches = 0
    for batch in loader:
        inv, codes = invert(batch["image"])
        inv, codes = inv.float().cpu().numpy(), codes.float().cpu().numpy()
        batches += 1
        for i, path in enumerate(batch["path"]):
            video_dir = os.path.dirname(os.path.dirname(path))
            frames_dir = os.path.join(video_dir, "inversion", "frames")
            codes_dir = os.path.join(video_dir, "inversion", "latent_codes")
            os.makedirs(frames_dir, exist_ok=True)
            os.makedirs(codes_dir, exist_ok=True)
            name = batch["filename"][i]
            if args.save_images:
                save_image(inv[i], os.path.join(frames_dir, f"{name}.png"))
            np.save(os.path.join(codes_dir, f"{name}.npy"), codes[i].astype(np.float32))
    print("done")
    return {"frames": len(dataset), "batches": batches}


if __name__ == "__main__":
    main()
