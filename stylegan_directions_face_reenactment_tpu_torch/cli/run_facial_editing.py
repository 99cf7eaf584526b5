"""Single-attribute facial editing (the reference's ``run_facial_editing.py``;
the JAX package's ``cli/run_facial_editing.py``).

Sweep one or more directions (0 yaw, 1 pitch, 2 roll, 3 jaw, 4 smile, 5-14
expressions) around the source's own value and write each step's image
and, with ``--save_gif``, a GIF. The source is an image (cropped, inverted
with e4e and, with ``--optimize_generator``, PTI-tuned, as
``run_inference``'s), a ``.npy`` W+ code, or, with no ``--source_path``, a
random z drawn from a ``torch.Generator`` seeded with ``--seed``. Runs on
the CUDA card unless ``--device cpu`` is given, and raises when there is no
card.

Usage:
  python -m stylegan_directions_face_reenactment_tpu_torch.cli.run_facial_editing \\
      --source_path img.png --directions 0 3 4 --output_path ./out --save_gif

Writes ``<out>/<name>/<name>_NNN.png`` (``--save_images``, on by default)
and ``<out>/<name>.gif`` (``--save_gif``) for each direction's name (yaw,
pitch, roll, jaw, exp_NN).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..geometry import initialize_directions
from ..models.stylegan2 import mapping
from ..pipeline import make_prep_fn, setup_source, sweep_direction
from ..pipeline.reenactment import source_shape
from ..pipeline.synthesis import generate_image
from ..utils.device import resolve_device
from ..utils.image_utils import load_image, save_image, tensor_to_image
from ..utils.visualization import save_gif
from . import model_loading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Facial attribute editing")
    p.add_argument("--source_path", default=None,
                   help="image (.png/.jpg), W+ latent (.npy), or omit for a random z")
    p.add_argument("--output_path", required=True)
    p.add_argument("--directions", type=int, nargs="+", required=True,
                   help="direction indices 0..14 (0 yaw, 1 pitch, 2 roll, 3 jaw, "
                        "4 smile, 5-14 expressions)")
    p.add_argument("--save_gif", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--save_images", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--optimize_generator", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--dataset_type", default="voxceleb")
    p.add_argument("--shifts_count", type=int, default=10)
    p.add_argument("--random_init", action="store_true",
                   help="seeded random weights instead of the checkpoint files")
    p.add_argument("--image_resolution", type=int, default=None,
                   help="the generator's resolution (default: the registry's)")
    p.add_argument("--skip_preprocess", action="store_true",
                   help="the source image is an FFHQ-cropped face already: no "
                        "detection or landmark crop")
    p.add_argument("--device_crop", action=argparse.BooleanOptionalAction, default=True,
                   help="cut the FFHQ crop on the device (--no-device_crop: the host "
                        "crop)")
    p.add_argument("--detect_width", type=int, default=None,
                   help="rescale the source to this width before detection (default: "
                        "the reference's 1000; 0 = its own size)")
    p.add_argument("--deca_alignment", default="fan", choices=["fan", "fan_frame", "resize"],
                   help="DECA preprocessing: 'fan' = the reference's SFD-detect → crop → "
                        "FAN → bbox → similarity warp to 224; 'fan_frame' = FAN on the "
                        "whole frame; 'resize' = bilinear")
    p.add_argument("--seed", type=int, default=0, help="the random z's seed")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def random_z(seed: int, device: torch.device) -> torch.Tensor:
    """The (1, 512) z of a source made from ``--seed``."""
    return torch.randn((1, 512), generator=torch.Generator().manual_seed(seed)).to(device)


def main(argv=None):
    """Run the CLI. Returns each direction's name with its sweep values,
    and the source the sweeps started from (W+ code, generator,
    coefficients and angles)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else args.device)
    os.makedirs(args.output_path, exist_ok=True)

    kw = dict(random_init=args.random_init, device=dev)
    g = model_loading.load_generator(args.dataset_type, resolution=args.image_resolution, **kw)
    a = model_loading.load_direction_matrix(args.dataset_type, **kw)
    deca = model_loading.load_deca(**kw)
    spec = initialize_directions(args.dataset_type, 15, 6.0)
    trunc = model_loading.compute_trunc(g).to(dev)
    sfd = fan = None
    if args.deca_alignment in ("fan", "fan_frame") or (
            args.source_path is not None and not args.source_path.endswith(".npy")
            and not args.skip_preprocess):
        sfd, fan = model_loading.load_face_models(**kw)
    fan_deca = fan if args.deca_alignment in ("fan", "fan_frame") else None
    sfd_deca = sfd if args.deca_alignment == "fan" else None

    # --- the source --------------------------------------------------------
    if args.source_path is None or args.source_path.endswith(".npy"):
        with torch.no_grad():
            if args.source_path is None:
                w = trunc + 0.7 * (mapping(g, random_z(args.seed, dev)) - trunc)
                source_code = w[:, None].repeat(1, g.n_latent, 1)
            else:
                code = np.load(args.source_path).astype(np.float32)
                source_code = torch.from_numpy(code.reshape(1, -1, 512)).to(dev)
            source_img = generate_image(g, source_code, truncation=0.7,
                                        truncation_latent=trunc, input_is_latent=True)
            params_source, angles_source = source_shape(deca, source_img, fan_deca, sfd_deca)
    else:
        e4e = model_loading.load_e4e(args.dataset_type, resolution=args.image_resolution, **kw)
        prep = make_prep_fn(None if args.skip_preprocess else sfd,
                            None if args.skip_preprocess else fan,
                            skip_preprocess=args.skip_preprocess, device_crop=args.device_crop,
                            detect_width=args.detect_width, device=dev)
        lp = model_loading.load_lpips(**kw) if args.optimize_generator else None
        _, source_code, g, params_source, angles_source = setup_source(
            g, e4e, deca, [load_image(args.source_path)], prep, truncation_latent=trunc,
            optimize_generator=args.optimize_generator, lpips_params=lp,
            fan_params=fan_deca, s3fd_params=sfd_deca, device=dev)

    params_np = {k: v.cpu().numpy() for k, v in params_source.items()}
    angles_np = angles_source.cpu().numpy()

    # --- the sweeps --------------------------------------------------------
    sweeps = {}
    for d in args.directions:
        with torch.no_grad():
            name, values, imgs = sweep_direction(
                g, a, spec, source_code, d, params_np, angles_np,
                shifts_count=args.shifts_count, truncation=0.7, truncation_latent=trunc)
        imgs = imgs.float().cpu().numpy()
        sweeps[name] = values
        ddir = os.path.join(args.output_path, name)
        os.makedirs(ddir, exist_ok=True)
        if args.save_images:
            for i in range(len(values)):
                save_image(imgs[i], os.path.join(ddir, f"{name}_{i:03d}.png"))
        if args.save_gif:
            frames = [tensor_to_image(im) for im in imgs]
            save_gif(frames + frames[::-1], os.path.join(args.output_path, f"{name}.gif"),
                     fps=15)
        print(f"direction {d} ({name}): {len(values)} steps -> {ddir}")
    return {"sweeps": sweeps, "source_code": source_code, "generator": g,
            "params_source": params_np, "angles_source": angles_np}


if __name__ == "__main__":
    main()
