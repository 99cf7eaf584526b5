"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none: the port
    never carries on quietly on the CPU. Pass ``device="cpu"`` for that."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
