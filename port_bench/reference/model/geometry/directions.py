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

from .rotations import batch_euler2axis, deg2rad

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

    def exp_slot(self, i: int) -> int:
        """Δp slot of learned expression i."""
        return self.count_pose + i


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


def make_shift_vector_50_from(spec: DirectionsSpec,
                              param_source: Dict[str, torch.Tensor],
                              param_target: Dict[str, torch.Tensor],
                              angles_source: torch.Tensor,
                              angles_target: torch.Tensor,
                              target_indices: torch.Tensor,
                              u: torch.Tensor) -> torch.Tensor:
    """The disentanglement-50 batch from explicit draws
    (``utils_train.py:177-288``): the first half the full Δp, each sample of
    the second half one direction ``target_indices`` (B/2,) moved to the
    uniform position ``u`` (B/2, in [0, 1)) of its range."""
    half = angles_source.shape[0] // 2
    full = make_shift_vector(spec, param_source, param_target, angles_source, angles_target)
    start = start_positions(spec, param_source, angles_source)[half:]
    idx = target_indices.long()
    start_sel = start.gather(1, idx[:, None])[:, 0]
    min_shift = -spec.shift_scale - start_sel
    max_shift = spec.shift_scale - start_sel
    shift_val = (min_shift - max_shift) * u.float() + max_shift
    second = torch.zeros((half, spec.learned_directions), dtype=torch.float32,
                         device=full.device)
    second = second.scatter(1, idx[:, None], shift_val[:, None])
    return torch.cat([full[:half], second], dim=0)


def draw_disentanglement_50(spec: DirectionsSpec, half: int, gen: torch.Generator,
                            device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(target_indices (half,) uniform over the directions, u (half,) in
    [0, 1)) drawn from ``gen`` on its device and moved to ``device``."""
    idx = torch.randint(0, spec.learned_directions, (half,), generator=gen,
                        device=gen.device)
    u = torch.rand((half,), generator=gen, device=gen.device)
    return idx.to(device), u.to(device)


def make_shift_vector_50(spec: DirectionsSpec,
                         param_source: Dict[str, torch.Tensor],
                         param_target: Dict[str, torch.Tensor],
                         angles_source: torch.Tensor,
                         angles_target: torch.Tensor,
                         gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """The disentanglement-50 batch with its draws from ``gen``: (shift
    vector (B, k), target_indices (B/2,)). The batch must be even."""
    b = angles_source.shape[0]
    if b % 2:
        raise ValueError("batch size must be even for disentanglement_50")
    idx, u = draw_disentanglement_50(spec, b // 2, gen, angles_source.device)
    return (make_shift_vector_50_from(spec, param_source, param_target, angles_source,
                                      angles_target, idx, u), idx)


def get_params_gt_reenacted(spec: DirectionsSpec,
                            param_source: Dict[str, torch.Tensor],
                            param_target: Dict[str, torch.Tensor],
                            shift_vector: torch.Tensor,
                            target_indices: torch.Tensor,
                            angles_source: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Ground-truth FLAME pose and expression of the reenacted face
    (``utils_train.py:291-374``): the target's for the first half of the
    batch; for the second, the source's with the one chosen attribute moved
    by its shift, pose directions through euler → axis-angle with the
    reference's component swap (x, y) → (y, −x) (``:310-314``)."""
    half = angles_source.shape[0] // 2
    idx = target_indices.long()
    ang_s = angles_source[half:].float()
    pose_s = param_source["pose"][half:]
    exp_s = param_source["alpha_exp"][half:]
    shift_sel = shift_vector[half:].gather(1, idx[:, None])[:, 0]

    new_pose3 = pose_s[:, :3]
    for axis, direction in enumerate((spec.yaw_direction, spec.pitch_direction,
                                      spec.roll_direction)):
        scale = spec.angle_scales[axis]
        start = ang_s[:, axis] * (spec.shift_scale / scale)
        ang = ang_s.clone()
        ang[:, axis] = (start + shift_sel) * (scale / spec.shift_scale)
        aa = batch_euler2axis(deg2rad(ang))
        aa = torch.stack([aa[:, 1], -aa[:, 0], aa[:, 2]], dim=-1)
        if direction != -1:
            new_pose3 = torch.where((idx == direction)[:, None], aa, new_pose3)

    # jaw: x' = x + shift / a, from ((a·x + b) + s − b) / a
    new_jaw = torch.where(idx == spec.jaw_index, pose_s[:, 3] + shift_sel / spec.a_jaw,
                          pose_s[:, 3])
    exp_new = exp_s.clone()
    for i in range(spec.num_expressions):
        ci = spec.exp_components[i]
        exp_new[:, ci] = torch.where(idx == spec.exp_slot(i),
                                     exp_s[:, ci] + shift_sel / spec.exp_a[i], exp_new[:, ci])

    pose_second = torch.cat([new_pose3, new_jaw[:, None], pose_s[:, 4:]], dim=1)
    return {"pose": torch.cat([param_target["pose"][:half], pose_second], dim=0),
            "exp": torch.cat([param_target["alpha_exp"][:half], exp_new], dim=0)}


def get_direction_info(spec: DirectionsSpec, direction_index: int,
                       params_source: Dict[str, np.ndarray], angles_source: np.ndarray,
                       shifts_count: int = 10):
    """A sweep of one direction for one source sample
    (``config_directions.py:42-85``): (name, start, min shift, max shift,
    step). The sweep runs from −shift_scale − start to shift_scale − start
    in steps of shift_scale / ``shifts_count``; ``params_source`` and
    ``angles_source`` are the source's coefficients and angles as arrays."""
    ss = spec.shift_scale
    pose_dirs = {spec.yaw_direction: ("yaw", 0), spec.pitch_direction: ("pitch", 1),
                 spec.roll_direction: ("roll", 2)}
    pose_dirs.pop(-1, None)

    if direction_index in pose_dirs:
        name, axis = pose_dirs[direction_index]
        source_angle = float(np.asarray(angles_source).reshape(-1, 3)[0, axis])
        start = source_angle * ss / spec.angle_scales[axis]
    elif direction_index == spec.jaw_index:
        jaw = float(np.asarray(params_source["pose"]).reshape(-1, 6)[0, 3])
        start = spec.a_jaw * jaw + spec.b_jaw
        name = "jaw"
    else:
        i = direction_index - spec.count_pose
        if not 0 <= i < spec.num_expressions:
            raise ValueError(f"unknown direction index {direction_index}")
        ci = spec.exp_components[i]
        val = float(np.asarray(params_source["alpha_exp"]).reshape(1, -1)[0, ci])
        start = spec.exp_a[i] * val + spec.exp_b[i]
        name = f"exp_{ci:02d}"
    return name, float(start), float(-ss - start), float(ss - start + 1e-5), ss / shifts_count
