"""Δp direction space: ranges, linear maps, shift-vector construction.

The Δp vector has ``learned_directions`` (k = 15) entries:
[yaw, pitch, roll, jaw, exp_0 … exp_{k-5}] (voxceleb layout; FFHQ drops
roll). Pose entries are degrees rescaled by ``shift_scale / angle_scale``;
jaw and expression entries go through per-direction affine maps ``a·x + b``
that send the measured [min, max] range (the package's own copy of
``configs/ranges_*.npy``) to [-shift_scale, +shift_scale].
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs")

DATASET_DICTS = {
    "voxceleb": dict(yaw_direction=0, pitch_direction=1, roll_direction=2,
                     jaw_direction=3, yaw_scale=40.0, pitch_scale=20.0,
                     roll_scale=20.0, ranges_file="ranges_voxceleb.npy"),
    "ffhq": dict(yaw_direction=0, pitch_direction=1, roll_direction=-1,
                 jaw_direction=3, yaw_scale=40.0, pitch_scale=20.0,
                 roll_scale=20.0, ranges_file="ranges_FFHQ.npy"),
}


def _line_through(x0, y0, x1, y1) -> Tuple[float, float]:
    """Exact a·x+b through two points."""
    a = (y1 - y0) / (x1 - x0)
    return float(a), float(y0 - a * x0)


def get_direction_ranges(path: str) -> np.ndarray:
    """Load the (54, 2) [min, max] statistics file."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"direction ranges file not found: {path}")
    return np.load(path).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class DirectionsSpec:
    """Static direction-space config."""
    learned_directions: int
    shift_scale: float
    count_pose: int
    num_expressions: int
    yaw_direction: int
    pitch_direction: int
    roll_direction: int
    angle_scales: Tuple[float, float, float]   # yaw, pitch, roll
    a_jaw: float
    b_jaw: float
    exp_a: Tuple[float, ...]                   # per learned expression
    exp_b: Tuple[float, ...]
    exp_components: Tuple[int, ...]            # DECA exp coefficient index
    exp_min: Tuple[float, ...]
    exp_max: Tuple[float, ...]
    jaw_min: float = 0.0
    jaw_max: float = 0.0

    @property
    def jaw_index(self) -> int:
        """Δp slot of the jaw direction (= count_pose - 1)."""
        return self.count_pose - 1


def initialize_directions(dataset_type: str = "voxceleb",
                          learned_directions: int = 15,
                          shift_scale: float = 6.0,
                          ranges_path: Optional[str] = None) -> DirectionsSpec:
    d = DATASET_DICTS[dataset_type.lower()]
    if ranges_path is None:
        ranges_path = os.path.join(_CONFIG_DIR, d["ranges_file"])
    ranges = get_direction_ranges(ranges_path)

    jaw_min, jaw_max = float(ranges[3][0]), float(ranges[3][1])
    exp_ranges = ranges[4:]
    count_pose = sum(1 for k in ("yaw_direction", "pitch_direction",
                                 "roll_direction") if d[k] != -1) + 1  # + jaw
    num_expressions = learned_directions - count_pose

    exp_a, exp_b, exp_lo, exp_hi = [], [], [], []
    for i in range(num_expressions):
        lo, hi = float(exp_ranges[i][0]), float(exp_ranges[i][1])
        a, b = _line_through(lo, -shift_scale, hi, shift_scale)
        exp_a.append(a)
        exp_b.append(b)
        exp_lo.append(lo)
        exp_hi.append(hi)
    # the jaw map always targets [-6, 6]
    a_jaw, b_jaw = _line_through(jaw_min, -6.0, jaw_max, 6.0)

    return DirectionsSpec(
        learned_directions=learned_directions,
        shift_scale=shift_scale,
        count_pose=count_pose,
        num_expressions=num_expressions,
        yaw_direction=d["yaw_direction"],
        pitch_direction=d["pitch_direction"],
        roll_direction=d["roll_direction"],
        angle_scales=(d["yaw_scale"], d["pitch_scale"], d["roll_scale"]),
        a_jaw=a_jaw, b_jaw=b_jaw,
        exp_a=tuple(exp_a), exp_b=tuple(exp_b),
        exp_components=tuple(range(num_expressions)),
        exp_min=tuple(exp_lo), exp_max=tuple(exp_hi),
        jaw_min=jaw_min, jaw_max=jaw_max,
    )


def start_positions(spec: DirectionsSpec, params: Dict[str, torch.Tensor],
                    angles: torch.Tensor) -> torch.Tensor:
    """Shift-space 'current position' per direction; (B, k) float32.

    Pose slots: angle·shift_scale/scale; jaw slot: a·jaw + b; expression
    slots: a·exp + b.
    """
    b = angles.shape[0]
    dev = angles.device
    start = torch.zeros((b, spec.learned_directions), dtype=torch.float32, device=dev)
    scales = torch.tensor(spec.angle_scales, dtype=torch.float32, device=dev)
    pose = angles.float() * (spec.shift_scale / scales)
    for axis, direction in enumerate((spec.yaw_direction, spec.pitch_direction,
                                      spec.roll_direction)):
        if direction != -1:
            start[:, direction] = pose[:, axis]
    start[:, spec.jaw_index] = spec.a_jaw * params["pose"][:, 3].float() + spec.b_jaw
    exp_a = torch.tensor(spec.exp_a, dtype=torch.float32, device=dev)
    exp_b = torch.tensor(spec.exp_b, dtype=torch.float32, device=dev)
    comp = torch.tensor(spec.exp_components, dtype=torch.long, device=dev)
    exp_vals = params["alpha_exp"][:, comp].float()
    start[:, spec.count_pose:spec.count_pose + spec.num_expressions] = (
        exp_a * exp_vals + exp_b)
    return start


def make_shift_vector(spec: DirectionsSpec,
                      param_source: Dict[str, torch.Tensor],
                      param_target: Dict[str, torch.Tensor],
                      angles_source: torch.Tensor,
                      angles_target: torch.Tensor) -> torch.Tensor:
    """Full-reenactment Δp = start(target) − start(source); (B, k)."""
    return (start_positions(spec, param_target, angles_target)
            - start_positions(spec, param_source, angles_source))
