"""Training hyperparameters (the reference's ``libs/configs/config_arguments.py``;
the JAX package's ``configs/arguments.py``, copied field for field)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainingArguments:
    """Defaults of ``config_arguments.py:6-33`` and ``run_trainer.py:88-93``."""
    # direction space
    shift_scale: float = 6.0
    min_shift: float = 0.1
    learned_directions: int = 15
    num_layers_shift: int = 8
    w_plus: bool = True
    disentanglement_50: bool = True

    # loss weights
    lambda_identity: float = 10.0
    lambda_perceptual: float = 10.0
    lambda_pixel_wise: float = 1.0     # paired only
    lambda_shape: float = 1.0
    lambda_mouth_shape: float = 1.0
    lambda_eye_shape: float = 1.0
    lambda_w_reg: float = 0.0

    # cadence
    steps_per_log: int = 10
    steps_per_save: int = 1000
    steps_per_ev_log: int = 1000
    validation_samples: int = 100

    # logging artifacts
    reenactment_fig: bool = True
    num_pairs_log: int = 4
    gif: bool = False
    evaluation: bool = True
    log_images_wandb: bool = True   # eval grids and GIF frames to wandb
                                    # (`utils_train.py:790-794,865-869`)

    # optimizer / schedule (`run_trainer.py:88-93`, `trainer.py:144`)
    lr: float = 1e-4
    weight_decay: float = 5e-4
    batch_size: int = 12
    # gradient accumulation: split each batch into this many microbatches,
    # average their gradients and make ONE Adam update (every loss is a
    # batch mean, so the update is the full batch's)
    grad_accum: int = 1
    test_batch_size: int = 4
    n_steps: int = 100_000

    # model / data
    training_method: str = "synthetic"   # synthetic | real | real_synthetic | paired
    dataset_type: str = "voxceleb"
    image_resolution: int = 256
    # DECA preprocessing: 'fan' = SFD crop → FAN bbox → similarity warp to
    # 224 as the reference (`decalib/datasets/datasets.py:57-86`; needs
    # FrozenModels.fan), 'fan_frame' = FAN on the whole frame, 'resize' =
    # plain bilinear
    deca_alignment: str = "fan"
    deca_image_size: int = 224          # the resize path's target
    # the synthesis's dtype inside the train step; A stays float32
    train_compute_dtype: str = "float32"   # float32 | bfloat16
    # memoize the fixed dataset frames' DECA coefficients (training
    # invariants) instead of recomputing them every step as the reference
    # does (`trainer.py:361-365`)
    cache_gt_shape: bool = True
    # recompute the under-grad blocks (shifted synthesis; DECA and the loss
    # nets) in the backward pass instead of keeping their activations
    remat: bool = False
    channel_multiplier: int = 2
    truncation: float = 0.7
    dim_z: int = 512

    train_dataset_path: Optional[str] = None
    test_dataset_path: Optional[str] = None
    experiment_path: str = "./training_attempts/exp_v00"
    resume_training_model: Optional[str] = None
    use_wandb: bool = False
    workers: int = 1
