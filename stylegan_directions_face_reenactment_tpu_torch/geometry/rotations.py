"""Batched rotation converters (euler / axis-angle / quaternion / matrix),
Rodrigues' formula and the weak-perspective projection of DECA and FLAME.

Conventions of the reference's ``rotation_converter.py``: quaternions are
(w, x, y, z); :func:`batch_matrix2euler` extracts (x = asin(R[2,0]),
y = atan2(R[2,1], R[2,2]), z = atan2(R[1,0], R[0,0])), which the pipeline
reads as (yaw, pitch, roll), vectorized with gimbal-lock handling.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def deg2rad(x):
    return x * (PI / 180.0)


def rad2deg(x):
    return x * (180.0 / PI)


def euler_to_quaternion(r: torch.Tensor) -> torch.Tensor:
    """Euler (..., 3) [x, y, z] radians → quaternion (..., 4) (w, x, y, z)."""
    x, y, z = r[..., 0] / 2.0, r[..., 1] / 2.0, r[..., 2] / 2.0
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    return torch.stack([
        cx * cy * cz - sx * sy * sz,
        cx * sy * sz + cy * cz * sx,
        cx * cz * sy - sx * cy * sz,
        cx * cy * sz + sx * cz * sy,
    ], dim=-1)


def angle_axis_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) → quaternion (..., 4) (ceres convention)."""
    theta_sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    nonzero = theta_sq > 0
    theta = torch.sqrt(torch.where(nonzero, theta_sq, torch.ones_like(theta_sq)))
    half = theta * 0.5
    k = torch.where(nonzero, torch.sin(half) / theta, torch.full_like(half, 0.5))
    w = torch.where(nonzero, torch.cos(half), torch.ones_like(half))
    return torch.cat([w, aa * k], dim=-1)


def quaternion_to_angle_axis(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) → axis-angle (..., 3) (ceres convention)."""
    q1, q2, q3 = q[..., 1], q[..., 2], q[..., 3]
    sin_sq = q1 * q1 + q2 * q2 + q3 * q3
    nonzero = sin_sq > 0
    sin_theta = torch.sqrt(torch.where(nonzero, sin_sq, torch.ones_like(sin_sq)))
    cos_theta = q[..., 0]
    two_theta = 2.0 * torch.where(
        cos_theta < 0.0,
        torch.atan2(-sin_theta, -cos_theta),
        torch.atan2(sin_theta, cos_theta))
    k = torch.where(nonzero, two_theta / sin_theta, torch.full_like(sin_theta, 2.0))
    return torch.stack([q1 * k, q2 * k, q3 * k], dim=-1)


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (B, 4) (w, x, y, z) → rotation matrix (B, 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rotation_matrix_to_quaternion(m: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotation matrix (B, 3, 3) → quaternion (B, 4), the reference's
    four-branch form (``rotation_converter.py:92-169``)."""
    rmat_t = m.transpose(-1, -2)
    r00, r01, r02 = rmat_t[..., 0, 0], rmat_t[..., 0, 1], rmat_t[..., 0, 2]
    r10, r11, r12 = rmat_t[..., 1, 0], rmat_t[..., 1, 1], rmat_t[..., 1, 2]
    r20, r21, r22 = rmat_t[..., 2, 0], rmat_t[..., 2, 1], rmat_t[..., 2, 2]

    mask_d2 = r22 < eps
    mask_d0_d1 = r00 > r11
    mask_d0_nd1 = r00 < -r11

    t0 = 1 + r00 - r11 - r22
    q0 = torch.stack([r12 - r21, t0, r01 + r10, r20 + r02], dim=-1)
    t1 = 1 - r00 + r11 - r22
    q1 = torch.stack([r20 - r02, r01 + r10, t1, r12 + r21], dim=-1)
    t2 = 1 - r00 - r11 + r22
    q2 = torch.stack([r01 - r10, r20 + r02, r12 + r21, t2], dim=-1)
    t3 = 1 + r00 + r11 + r22
    q3 = torch.stack([t3, r12 - r21, r20 - r02, r01 - r10], dim=-1)

    cases = ((mask_d2 & mask_d0_d1, q0, t0), (mask_d2 & ~mask_d0_d1, q1, t1),
             (~mask_d2 & mask_d0_nd1, q2, t2), (~mask_d2 & ~mask_d0_nd1, q3, t3))
    q = sum(torch.where(c[..., None], qi / torch.sqrt(torch.clamp_min(t, eps))[..., None],
                        torch.zeros_like(qi)) for c, qi, t in cases)
    return q * 0.5


def batch_rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """Axis-angle (N, 3) → rotation matrices (N, 3, 3) (``lbs.py:274-305``):
    the angle is the norm of ``rot_vecs + 1e-8``, as the reference's."""
    angle = torch.linalg.norm(rot_vecs + 1e-8, dim=-1, keepdim=True)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = rot_dir[..., 0], rot_dir[..., 1], rot_dir[..., 2]
    zeros = torch.zeros_like(rx)
    k = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=-1).reshape(rot_vecs.shape[:-1] + (3, 3))
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return ident + sin * k + (1 - cos) * torch.matmul(k, k)


def batch_euler2axis(r: torch.Tensor) -> torch.Tensor:
    return quaternion_to_angle_axis(euler_to_quaternion(r))


def batch_euler2matrix(r: torch.Tensor) -> torch.Tensor:
    return quaternion_to_rotation_matrix(euler_to_quaternion(r))


def batch_matrix2axis(m: torch.Tensor) -> torch.Tensor:
    return quaternion_to_angle_axis(rotation_matrix_to_quaternion(m))


def batch_axis2matrix(theta: torch.Tensor) -> torch.Tensor:
    return quaternion_to_rotation_matrix(angle_axis_to_quaternion(theta))


def batch_matrix2euler(rot_mats: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (B, 3, 3) → euler (B, 3) [x=yaw, y=pitch, z=roll],
    with gimbal lock where |R[2,0]| > 0.998."""
    r20 = rot_mats[..., 2, 0]
    lock_up = r20 > 0.998
    lock_dn = r20 < -0.998
    lock = lock_up | lock_dn

    x_reg = torch.asin(torch.clamp(r20, -1.0, 1.0))
    y_reg = torch.atan2(rot_mats[..., 2, 1], rot_mats[..., 2, 2])
    z_reg = torch.atan2(rot_mats[..., 1, 0], rot_mats[..., 0, 0])

    x_lock = torch.where(lock_up, torch.full_like(r20, PI / 2.0),
                         torch.full_like(r20, -PI / 2.0))
    y_lock = torch.where(lock_up,
                         torch.atan2(-rot_mats[..., 0, 1], -rot_mats[..., 0, 2]),
                         torch.atan2(rot_mats[..., 0, 1], rot_mats[..., 0, 2]))
    z_lock = torch.zeros_like(z_reg)

    x = torch.where(lock, x_lock, x_reg)
    y = torch.where(lock, y_lock, y_reg)
    z = torch.where(lock, z_lock, z_reg)
    return torch.stack([x, y, z], dim=-1)


def batch_axis2euler(theta: torch.Tensor) -> torch.Tensor:
    return batch_matrix2euler(batch_axis2matrix(theta))


def batch_orth_proj(x: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """Weak-perspective projection (``rotation_converter.py:364-372``):
    x (B, P, 3), camera (B, 3) = [scale, tx, ty] → (B, P, 3)."""
    cam = camera.reshape(-1, 1, 3)
    x_trans = torch.cat([x[:, :, :2] + cam[:, :, 1:], x[:, :, 2:]], dim=2)
    return cam[:, :, 0:1] * x_trans
