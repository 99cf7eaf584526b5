"""The direction matrix A's file (the reference's ``utils_train.py:590-603``;
the JAX package's ``train/checkpoints.py``): written by the trainer, read
by the trainer's resume and by the inference and editing CLIs.

The bundle holds {step, A's weight and bias, learned_directions,
shift_scale, w_plus, num_layers_shift}. It is written as the JAX package's
``.npz`` (numpy alone, so either package reads the other's); the loader also
takes the reference's torch ``.pt`` bundle ({step, A_matrix (state dict),
...}).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.direction_matrix import DirectionMatrix
from ..utils.device import DeviceLike, resolve_device


def save_a_matrix(models_dir: str, a: DirectionMatrix, step: int, learned_directions: int,
                  shift_scale: float, w_plus: bool, num_layers_shift: int) -> str:
    """Write ``A_matrix_{step:06d}.npz`` under ``models_dir``; returns its path."""
    os.makedirs(models_dir, exist_ok=True)
    path = os.path.join(models_dir, f"A_matrix_{step:06d}.npz")
    bias = a.linear.bias
    np.savez(path, step=step,
             weight=a.linear.weight.detach().float().cpu().numpy(),
             bias=(np.zeros(0, np.float32) if bias is None
                   else bias.detach().float().cpu().numpy()),
             learned_directions=learned_directions, shift_scale=shift_scale,
             w_plus=w_plus, num_layers_shift=num_layers_shift)
    return path


def _read_bundle(path: str) -> Tuple[int, Dict[str, torch.Tensor], Dict[str, Any]]:
    """(step, state dict, meta) of an ``.npz`` or reference ``.pt`` bundle."""
    if path.endswith(".npz"):
        z = np.load(path)
        sd = {"linear.weight": torch.from_numpy(z["weight"])}
        if z["bias"].size:
            sd["linear.bias"] = torch.from_numpy(z["bias"])
        meta = {"learned_directions": int(z["learned_directions"]),
                "shift_scale": float(z["shift_scale"]), "w_plus": bool(z["w_plus"]),
                "num_layers_shift": int(z["num_layers_shift"])}
        return int(z["step"]), sd, meta
    bundle = torch.load(path, map_location="cpu")
    sd = bundle["A_matrix"] if "A_matrix" in bundle else bundle
    meta = {k: bundle.get(k) for k in ("learned_directions", "shift_scale", "w_plus",
                                       "num_layers_shift")}
    meta["w_plus"] = bool(bundle.get("w_plus", True))
    meta["num_layers_shift"] = int(bundle.get("num_layers_shift", 8))
    return (int(bundle.get("step", 0)),
            {k: sd[k] for k in ("linear.weight", "linear.bias") if k in sd}, meta)


def load_a_matrix(path: str, device: DeviceLike = None
                  ) -> Tuple[int, DirectionMatrix, Dict[str, Any]]:
    """(step, A on ``device``, meta) from an ``.npz`` bundle (this package's
    or the JAX package's) or the reference's torch bundle."""
    step, sd, meta = _read_bundle(path)
    out_dim, input_dim = sd["linear.weight"].shape
    w_plus, num_layers = meta["w_plus"], meta["num_layers_shift"]
    a = DirectionMatrix(out_dim // num_layers if w_plus else out_dim, input_dim,
                        w_plus=w_plus, num_layers=num_layers, bias="linear.bias" in sd)
    a.load_state_dict({k: v.float() for k, v in sd.items()})
    return step, a.to(resolve_device(device)), meta
