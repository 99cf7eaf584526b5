"""The rank side of ``tests/test_torch_parallel.py``: what each process of a
gloo world of 2 on the CPU runs. It imports the port and nothing of JAX
(the spawned ranks must not start JAX), so the test module hands it the
port's nets and inputs in a ``torch.save`` file.

Cases, each on the world's rows of one global batch (``parallel/mesh.py``):
``paired`` (batch 2, cached coefficients, the optimizer step: A's
gradient averaged over the world), ``synthetic`` (batch 4 with
disentanglement-50: every rank draws the global batch from one generator
seed and keeps its block of each half),
``accum`` (paired, batch 4 in 2 microbatches, reduced once) and
``trainer`` (2 synthetic steps of the ``Trainer`` with a save and an
evaluation every step, each rank writing under its own experiment path so
that the test sees who wrote; the evaluation's batches of 2 are sharded, a
row a rank; then one more evaluation of a batch of 3, which does not divide
the world and runs whole on every rank).
"""

import dataclasses
import os
import sys

import torch

from stylegan_directions_face_reenactment_tpu_torch.configs import TrainingArguments
from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
from stylegan_directions_face_reenactment_tpu_torch.parallel import shard_batch, world_info
from stylegan_directions_face_reenactment_tpu_torch.train import (
    Trainer, make_accum_step, make_optimizer, make_paired_step, make_synthetic_step)
from stylegan_directions_face_reenactment_tpu_torch.weights import init_direction_matrix

WORLD = 2
SPEC = initialize_directions()
# the settings of tests/test_torch_train_steps.py (64² generator, DECA at 64
# on the resize alignment, the ID term out)
COMMON = dict(image_resolution=64, lambda_identity=0.0, lambda_w_reg=0.5,
              deca_image_size=64, deca_alignment="resize")


def case_args(case):
    """The TrainingArguments of a case (the test's one-process runs take
    the same)."""
    return {"paired": TrainingArguments(batch_size=2, training_method="paired", **COMMON),
            "synthetic": TrainingArguments(batch_size=4, **COMMON),
            "accum": TrainingArguments(batch_size=4, training_method="paired", grad_accum=2,
                                       **COMMON),
            "trainer": TrainingArguments(batch_size=2, disentanglement_50=False,
                                         steps_per_log=1, steps_per_save=1, evaluation=True,
                                         steps_per_ev_log=1, validation_samples=4,
                                         test_batch_size=2, **COMMON)}[case]


# the paired step's inputs; cached: the frames' coefficients are the
# test's, fed to the JAX step too
CACHED = ("src_w", "tgt_w", "tgt_img", "p_src", "ang_src", "p_tgt", "ang_tgt")
UNCACHED = ("src_w", "src_img", "tgt_w", "tgt_img")


def updated(a, terms):
    """What a step leaves: its terms, A's (world-mean) gradient, A."""
    return ({k: float(v) for k, v in terms.items()},
            {n.split(".")[-1]: p.grad.detach().clone() for n, p in a.named_parameters()},
            {n.split(".")[-1]: p.detach().clone() for n, p in a.named_parameters()})


def run_rank(path, out_dir):
    """Every case on this rank; returns {case: result} and whether JAX was
    imported."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers // WORLD))
    rank, world = world_info()
    assert world == WORLD, world
    data = torch.load(path, weights_only=False)
    models, inputs = data["models"], data["inputs"]
    out = {}

    for case, keys in (("paired", CACHED), ("accum", UNCACHED)):
        args = case_args(case)
        a = init_direction_matrix(8, device="cpu")
        opt = make_optimizer(a, args)
        step = make_accum_step(make_paired_step, models, SPEC, args, opt,
                               cached_shape=case == "paired")
        # this rank's block of each microbatch, as the Trainer gives it
        extra = [shard_batch(inputs[case][k], groups=args.grad_accum) for k in keys]
        out[case] = updated(a, step(a, None, *extra))

    args = case_args("synthetic")
    a = init_direction_matrix(8, device="cpu")
    step = make_synthetic_step(models, SPEC, args, make_optimizer(a, args))
    out["synthetic"] = updated(a, step(a, torch.Generator().manual_seed(5)))

    args = case_args("trainer")
    args.experiment_path = os.path.join(out_dir, f"rank{rank}")
    trainer = Trainer(args, models, log_fn=lambda s: None)
    a = trainer.train(0, n_steps=2)
    out["trainer"] = {n.split(".")[-1]: p.detach().clone() for n, p in a.named_parameters()}
    # a batch of 3 does not divide the world: whole on every rank
    trainer.args = dataclasses.replace(args, test_batch_size=3)
    trainer.evaluate(a, step=2, num_samples=3, save_figure=False)
    out["trainer_metrics"] = trainer.metrics_log
    return out, "jax" in sys.modules
