"""Train the direction matrix A (the reference's ``run_trainer.py``; the JAX
package's ``cli/run_trainer.py``).

Usage:
  python -m stylegan_directions_face_reenactment_tpu_torch.cli.run_trainer \\
      --training_method paired --experiment_path ./attempts/v00 \\
      --train_dataset_path ... --test_dataset_path ...

The flags are the JAX package's (the reference's ``run_trainer.py:67-99``),
plus ``--device``: the CUDA card by default (it raises without one), or the
CPU. The experiment directory gets the ``_{dataset}_{method}`` suffix of
``run_trainer.py:105``. A batch is never split into microbatches unless
``--grad_accum`` asks for it.

Several cards (data parallelism, ``parallel/mesh.py``):
  * ``--n_devices N`` spawns N ranks on this host, one card each, joined
    with NCCL (gloo with ``--device cpu``: N CPU processes);
  * under torchrun (its ``WORLD_SIZE`` ... set) the world is torchrun's,
    across hosts with ``--dcn_slices`` (one row of ranks a host):
    ``torchrun --nnodes H --nproc_per_node C ... -m
    stylegan_directions_face_reenactment_tpu_torch.cli.run_trainer
    --dcn_slices H``.
``--batch_size`` is the global batch; each rank takes its rows.
"""

from __future__ import annotations

import argparse
import os

from ..parallel.mesh import distributed_init, launch, make_hybrid_mesh, make_mesh
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
                   help="data parallelism over this many cards of this host: one "
                        "spawned rank a card (NCCL); default one card")
    p.add_argument("--dcn_slices", type=int, default=1,
                   help="hosts of a multi-host run started by torchrun (one row of "
                        "ranks a host, parallel/mesh.py::make_hybrid_mesh); the "
                        "world comes from torchrun's environment")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the nets run: the CUDA card (it raises without one) "
                        "or the CPU")
    return p


def _rank_main(argv):
    """A spawned rank's run: rank 0 returns its A on the CPU."""
    _, a = main(argv)
    return a.cpu() if int(os.environ["RANK"]) == 0 else None


def main(argv=None):
    """Run the CLI; returns the Trainer and the trained A. With
    ``--n_devices`` > 1 outside torchrun it spawns the ranks and returns
    (None, rank 0's A on the CPU)."""
    argv = list(argv) if argv is not None else None
    args_ns = build_parser().parse_args(argv)
    on_cpu = args_ns.device == "cpu"
    n_dev = args_ns.n_devices or 1
    if args_ns.dcn_slices > 1 or os.environ.get("WORLD_SIZE"):
        if not distributed_init(device=args_ns.device if on_cpu else None):
            raise ValueError("--dcn_slices > 1 trains across hosts: start every host's "
                             "ranks with torchrun (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, "
                             "RANK, LOCAL_RANK)")
        # the world's checks: dcn_slices divides it, n_devices names all of it
        make_hybrid_mesh(args_ns.n_devices, dcn_slices=args_ns.dcn_slices,
                         device=args_ns.device if on_cpu else None)
    elif n_dev > 1:
        if args_ns.batch_size % n_dev:
            raise ValueError(f"batch_size {args_ns.batch_size} must divide the mesh "
                             f"({n_dev} devices) for data-parallel training")
        make_mesh(n_dev, device=args_ns.device if on_cpu else None)   # enough cards?
        ranks = launch(_rank_main, n_dev, argv, backend="gloo" if on_cpu else "nccl")
        return None, ranks[0]
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
