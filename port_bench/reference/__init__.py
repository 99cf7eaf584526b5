"""The plain reference: a frozen copy of the port's model code
(``model/``) with every kernel replaced by its plain PyTorch arithmetic,
run in float32 with TF32 off. It imports nothing of the port or of JAX."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def plain_float32():
    """TF32 off for cuDNN and matmuls while the reference runs, restored
    after."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
