"""Train the direction matrix A (the reference's ``run_trainer.py``; the JAX
package's ``cli/run_trainer.py``).

Usage:
  python -m stylegan_directions_face_reenactment_tpu_torch.cli.run_trainer \\
      --training_method paired --experiment_path ./attempts/v00 \\
      --train_dataset_path ... --test_dataset_path ...

The flags are the JAX package's (the reference's ``run_trainer.py:67-99``),
plus ``--device``: the CUDA card by default (it raises without one), or the
CPU. The experiment directory gets the ``_{dataset}_{method}`` suffix of
``run_trainer.py:105``. One card: ``--n_devices`` > 1 and ``--dcn_slices``
> 1 raise. A batch is never split into microbatches unless
``--grad_accum`` asks for it.
"""

from __future__ import annotations

import argparse

from ..utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the direction matrix A")
    p.add_argument("--experiment_path", default="./training_attempts/exp_v00")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--log_images_wandb", action="store_true")
    p.add_argument("--project_wandb", default="face-reenactment")
    p.add_argument("--resume_training_model", default=None)
    p.add_argument("--training_method", default="synthetic",
                   choices=["synthetic", "real", "real_synthetic", "paired"])
    p.add_argument("--synthetic_dataset_path", default=None)
    p.add_argument("--train_dataset_path", default=None)
    p.add_argument("--test_dataset_path", default=None)
    p.add_argument("--dataset_type", default="voxceleb", choices=["voxceleb", "ffhq"])
    p.add_argument("--image_resolution", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--test_batch_size", type=int, default=4)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--n_steps", type=int, default=100_000)
    p.add_argument("--random_init", action="store_true",
                   help="seeded random weights instead of the checkpoint files")
    p.add_argument("--deca_alignment", default="fan", choices=["fan", "fan_frame", "resize"],
                   help="DECA preprocessing on the training path: 'fan' = the "
                        "reference's SFD crop → FAN warp (detectors.py:23-42, "
                        "datasets.py:57-86), 'fan_frame' = FAN on the whole frame, "
                        "'resize' = bilinear")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--grad_accum", type=int, default=None,
                   help="microbatches a step: their gradients are averaged into ONE "
                        "Adam update, the same update as the whole batch's "
                        "(default 1)")
    p.add_argument("--train_compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the synthesis's dtype inside the train step (A stays float32)")
    p.add_argument("--cache_gt_shape", action=argparse.BooleanOptionalAction, default=True,
                   help="paired and real methods: keep the fixed dataset frames' DECA "
                        "coefficients instead of recomputing them every step")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=False,
                   help="recompute the under-grad blocks in the backward "
                        "(torch.utils.checkpoint): memory for time")
    p.add_argument("--no_evaluation", action="store_true",
                   help="no evaluation cadence (runs without a validation set)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="cards to train over (only 1 is ported)")
    p.add_argument("--dcn_slices", type=int, default=1,
                   help="hosts of a multi-host run (only 1 is ported)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the nets run: the CUDA card (it raises without one) "
                        "or the CPU")
    return p


def main(argv=None):
    """Run the CLI; returns the Trainer and the trained A."""
    args_ns = build_parser().parse_args(argv)
    if (args_ns.n_devices or 1) > 1 or args_ns.dcn_slices > 1:
        raise NotImplementedError("data-parallel training over several cards is not "
                                  "ported yet (ROADMAP): --n_devices and --dcn_slices "
                                  "must be 1")
    dev = resolve_device(None if args_ns.device == "cuda" else args_ns.device)

    from ..configs.arguments import TrainingArguments
    from ..train import FrozenModels, Trainer
    from . import model_loading as ml

    targs = TrainingArguments(
        experiment_path=(f"{args_ns.experiment_path}_"
                         f"{args_ns.dataset_type}_{args_ns.training_method}"),
        training_method=args_ns.training_method, dataset_type=args_ns.dataset_type,
        image_resolution=args_ns.image_resolution, lr=args_ns.lr,
        batch_size=args_ns.batch_size, test_batch_size=args_ns.test_batch_size,
        n_steps=args_ns.n_steps, train_dataset_path=args_ns.train_dataset_path,
        test_dataset_path=args_ns.test_dataset_path,
        resume_training_model=args_ns.resume_training_model,
        use_wandb=args_ns.use_wandb, workers=args_ns.workers,
        log_images_wandb=args_ns.log_images_wandb, deca_alignment=args_ns.deca_alignment,
        train_compute_dtype=args_ns.train_compute_dtype,
        cache_gt_shape=args_ns.cache_gt_shape, remat=args_ns.remat,
        evaluation=not args_ns.no_evaluation, grad_accum=args_ns.grad_accum or 1)

    rand = args_ns.random_init
    g = ml.load_generator(targs.dataset_type, random_init=rand,
                          resolution=targs.image_resolution, device=dev)
    fan = sfd = None
    if targs.deca_alignment in ("fan", "fan_frame"):
        sfd, fan = ml.load_face_models(random_init=rand, device=dev)
        if targs.deca_alignment == "fan_frame":
            sfd = None
    models = FrozenModels(g, ml.load_deca(random_init=rand, device=dev),
                          ml.load_id_backbone(random_init=rand, device=dev),
                          ml.load_lpips(random_init=rand, device=dev),
                          ml.compute_trunc(g), fan, sfd)
    trainer = Trainer(targs, models)
    if targs.training_method == "synthetic":
        a = trainer.train(args_ns.seed)
    elif targs.training_method in ("real", "real_synthetic"):
        a = trainer.train_real(args_ns.seed)
    else:
        a = trainer.train_paired(args_ns.seed)
    return trainer, a


if __name__ == "__main__":
    main()
