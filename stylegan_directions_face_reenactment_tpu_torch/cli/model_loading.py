"""Checkpoint loading for the CLI entry points (the JAX package's
``cli/model_loading.py``).

Each loader reads the reference's checkpoint file (``configs/
models_config.py``, the README download table) with ``torch.load`` onto the
CPU and loads it with ``load_state_dict`` into the port's module, which
keeps the reference's key layout; the module is then moved to ``device``
(the CUDA card by default; it raises when there is none). Every key must
match, except the generator's fixed ``noises.*`` buffers, which the
voxceleb generator file does not hold (the reference loads it with
``strict=False``); they stay zero, as the JAX package fills them. The
reference's modulated-conv weights carry a leading axis of 1 that the
port's do not. ``random_init`` builds the seeded weights of ``weights/``
instead.

DECA is the DECA file's ``E_flame`` with the FLAME model read from
``generic_model.pkl`` and ``landmark_embedding.npy``
(``weights/flame_loader.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..configs.models_config import AUX_MODELS, MODELS
from ..losses.lpips import LPIPS
from ..models.deca.deca import DECA
from ..models.direction_matrix import DirectionMatrix
from ..models.e4e import Encoder4Editing
from ..models.face.fan import FAN
from ..models.face.s3fd import S3FD
from ..models.stylegan2 import Generator, mean_latent
from ..utils.device import DeviceLike, resolve_device
from ..weights import (init_deca, init_direction_matrix, init_e4e, init_fan,
                       init_generator, init_lpips, init_s3fd, load_flame_params)


def _torch_load(path: str):
    return torch.load(path, map_location="cpu")


def load_into(module: nn.Module, sd: Mapping[str, torch.Tensor],
              may_miss: Sequence[str] = ()) -> nn.Module:
    """``module.load_state_dict(sd)`` that lets only keys starting with one
    of ``may_miss`` be missing; any other missing or unexpected key, or a
    wrong shape, raises."""
    missing, unexpected = module.load_state_dict(dict(sd), strict=False)
    missing = [k for k in missing if not k.startswith(tuple(may_miss))]
    if missing or unexpected:
        raise KeyError(f"{type(module).__name__}: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return module


def load_generator(dataset_type: str = "voxceleb", path: Optional[str] = None,
                   random_init: bool = False, seed: int = 0,
                   resolution: Optional[int] = None,
                   device: DeviceLike = None) -> Generator:
    cfg = MODELS[dataset_type]
    res = resolution or cfg["resolution"]
    if random_init:
        return init_generator(seed, res, cfg["style_dim"], cfg["n_mlp"],
                              cfg["channel_multiplier"], device=device)
    ckpt = _torch_load(path or cfg["generator_path"])
    sd = {k: (v[0] if k.endswith("conv.weight") and v.ndim == 5 else v)
          for k, v in ckpt.get("g_ema", ckpt).items()}
    g = Generator(res, cfg["style_dim"], cfg["n_mlp"], cfg["channel_multiplier"])
    return load_into(g, sd, may_miss=("noises.",)).to(resolve_device(device))


def load_e4e(dataset_type: str = "voxceleb", path: Optional[str] = None,
             random_init: bool = False, seed: int = 1,
             resolution: Optional[int] = None,
             device: DeviceLike = None) -> Encoder4Editing:
    res = resolution or MODELS[dataset_type]["resolution"]
    if random_init:
        return init_e4e(seed, res, device=device)
    ckpt = _torch_load(path or MODELS[dataset_type]["e4e_path"])
    return load_into(Encoder4Editing(res), ckpt.get("e", ckpt)).to(resolve_device(device))


def _a_matrix_arrays(path: str) -> Tuple[Dict[str, torch.Tensor], bool, int]:
    """(state dict, w_plus, num_layers) of an A bundle: the JAX package's
    ``.npz`` (``train/checkpoints.py::save_a_matrix``) or the reference's
    torch bundle (``utils_train.py:592-603``)."""
    if path.endswith(".npz"):
        z = np.load(path)
        sd = {"linear.weight": torch.from_numpy(z["weight"])}
        if z["bias"].size:
            sd["linear.bias"] = torch.from_numpy(z["bias"])
        return sd, bool(z["w_plus"]), int(z["num_layers_shift"])
    bundle = _torch_load(path)
    sd = bundle["A_matrix"] if "A_matrix" in bundle else bundle
    return ({k: sd[k] for k in ("linear.weight", "linear.bias") if k in sd},
            bool(bundle.get("w_plus", True)), int(bundle.get("num_layers_shift", 8)))


def load_direction_matrix(dataset_type: str = "voxceleb", path: Optional[str] = None,
                          random_init: bool = False, seed: int = 2,
                          device: DeviceLike = None) -> DirectionMatrix:
    if random_init:
        return init_direction_matrix(seed, 512, 15, w_plus=True, num_layers=8,
                                     device=device)
    sd, w_plus, num_layers = _a_matrix_arrays(path or MODELS[dataset_type]["directions_path"])
    out_dim, input_dim = sd["linear.weight"].shape
    a = DirectionMatrix(out_dim // num_layers if w_plus else out_dim, input_dim,
                        w_plus=w_plus, num_layers=num_layers, bias="linear.bias" in sd)
    return load_into(a, {k: v.float() for k, v in sd.items()}).to(resolve_device(device))


def load_deca(path: Optional[str] = None, flame_path: Optional[str] = None,
              flame_lmk_path: Optional[str] = None, random_init: bool = False,
              seed: int = 3, device: DeviceLike = None) -> DECA:
    if random_init:
        return init_deca(seed, device=device)
    deca = DECA(load_flame_params(flame_path or AUX_MODELS["flame"],
                                  flame_lmk_path or AUX_MODELS["flame_landmarks"]))
    load_into(deca.E_flame, _torch_load(path or AUX_MODELS["deca"])["E_flame"])
    return deca.to(resolve_device(device))


def load_face_models(sfd_path: Optional[str] = None, fan_path: Optional[str] = None,
                     random_init: bool = False, seed: int = 4,
                     device: DeviceLike = None) -> Tuple[S3FD, FAN]:
    """(S3FD, FAN); the FAN file's module count is read from its keys."""
    if random_init:
        return init_s3fd(seed, device=device), init_fan(seed + 1, 4, device=device)
    dev = resolve_device(device)
    sfd = load_into(S3FD(), _torch_load(sfd_path or AUX_MODELS["sfd"]))
    fan_ckpt = _torch_load(fan_path or AUX_MODELS["fan_2d"])
    fan_sd = fan_ckpt.get("state_dict", fan_ckpt)
    n = sum(1 for k in fan_sd if re.fullmatch(r"conv_last\d+\.weight", k))
    return sfd.to(dev), load_into(FAN(n), fan_sd).to(dev)


def load_lpips(path: Optional[str] = None, random_init: bool = False, seed: int = 6,
               device: DeviceLike = None) -> LPIPS:
    """The LPIPS bundle: torchvision AlexNet ``features`` and the v0.1
    linear heads."""
    if random_init:
        return init_lpips(seed, device=device)
    bundle = _torch_load(path or AUX_MODELS["lpips_alex"])
    lp = LPIPS()
    load_into(lp.net.layers, bundle["alex_features"])
    load_into(lp.lin, bundle["lin"])
    return lp.to(resolve_device(device))


def compute_trunc(g: Generator, seed: int = 42, n: int = 4096) -> torch.Tensor:
    """The truncation's mean W over ``n`` z's drawn from ``seed``."""
    with torch.no_grad():
        return mean_latent(g, torch.Generator().manual_seed(seed), n)
