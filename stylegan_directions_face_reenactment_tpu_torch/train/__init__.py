"""Training the direction matrix A: the loss stack, the steps of the four
methods, evaluation, checkpoints and the Trainer."""

from ..weights.a_matrix import load_a_matrix, save_a_matrix
from .checkpoints import start_from_checkpoint
from .eval import expression_error, extract_evaluation_metrics, pose_error
from .losses_stack import calculate_losses, calculate_losses_paired
from .steps import (Draws, FrozenModels, make_accum_step, make_align_fn, make_optimizer,
                    make_paired_step, make_real_step, make_shape_program,
                    make_synthetic_step, sample_draws)
from .trainer import Trainer

__all__ = ["load_a_matrix", "save_a_matrix", "start_from_checkpoint", "expression_error",
           "extract_evaluation_metrics", "pose_error", "calculate_losses",
           "calculate_losses_paired", "Draws", "FrozenModels", "make_accum_step",
           "make_align_fn", "make_optimizer", "make_paired_step", "make_real_step",
           "make_shape_program", "make_synthetic_step", "sample_draws", "Trainer"]
