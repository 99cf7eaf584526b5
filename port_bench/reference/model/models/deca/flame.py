"""FLAME head model: blendshapes, linear blend skinning and landmarks.

PyTorch counterpart of the JAX package's ``models/deca/flame.py`` (the
reference's ``libs/DECA/decalib/models/FLAME.py`` and ``lbs.py``):

    v = LBS(v_template + shapedirs·[β, ψ] + posedirs·(R − I))

over 5 joints (global, neck, jaw, left eye, right eye), with 51 static
barycentric landmarks and a 17-landmark contour picked by the neck's
rotation from a 79-entry table. The table index is an integer and is
detached, as the reference's ``index_select``.

The model's arrays live in :class:`FLAME` as buffers that are not part of a
state dict (the DECA checkpoint does not hold them): from ``generic_model.pkl``
through ``weights/flame_loader.py``, from the JAX package's pytree through
``weights/from_jax.py::flame_from_jax``, or from
:func:`synthetic_flame_params` for tests. :func:`flametex_forward`,
below, decodes the texture space; ``render.py::decode_deca`` calls it.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...geometry.rotations import batch_rodrigues
from ..nn import full_f32_matmul

NUM_JOINTS = 5
PARENTS = (-1, 0, 1, 1, 1)
NECK_KIN_CHAIN = (1, 0)  # neck, then its parent (global)
FLOAT_KEYS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
              "lmk_bary_coords", "dynamic_lmk_bary_coords", "full_lmk_bary_coords")
INDEX_KEYS = ("faces", "lmk_faces_idx", "dynamic_lmk_faces_idx", "full_lmk_faces_idx")


class FLAME(nn.Module):
    """The FLAME arrays as non-persistent buffers: ``v_template`` (V, 3),
    ``shapedirs`` (V, 3, n_shape + n_exp), ``posedirs`` (36, V·3),
    ``j_regressor`` (5, V), ``lbs_weights`` (V, 5), ``faces`` (F, 3), the
    static landmarks' ``lmk_faces_idx`` (51,) and ``lmk_bary_coords``
    (51, 3), the contour table's ``dynamic_lmk_faces_idx`` (79, 17) and
    ``dynamic_lmk_bary_coords`` (79, 17, 3), and the 68 3D landmarks'
    ``full_lmk_faces_idx`` (68,) and ``full_lmk_bary_coords`` (68, 3).
    Indices are int64, the rest float32."""

    def __init__(self, params: Mapping[str, object]):
        super().__init__()
        for k in FLOAT_KEYS + INDEX_KEYS:
            dtype = torch.int64 if k in INDEX_KEYS else torch.float32
            self.register_buffer(k, torch.as_tensor(np.array(params[k])).to(dtype),
                                 persistent=False)


class FLAMETex(nn.Module):
    """The texture space as non-persistent buffers: ``texture_mean``
    (1, 512·512·3) and ``texture_basis`` (512·512·3, n_tex), float32."""

    def __init__(self, texture_mean, texture_basis):
        super().__init__()
        self.register_buffer("texture_mean", torch.as_tensor(
            np.array(texture_mean, np.float32)).reshape(1, -1), persistent=False)
        self.register_buffer("texture_basis", torch.as_tensor(
            np.array(texture_basis, np.float32)), persistent=False)


def flametex_forward(flametex: FLAMETex, texcode: torch.Tensor) -> torch.Tensor:
    """Texture code (B, n_tex) → (B, 256, 256, 3) NHWC albedo, channels
    flipped as the reference's; the 512 → 256 step is ``F.interpolate``'s
    default nearest, every other pixel (``FLAME.py:253-262``). The basis
    sum is one float32 product (TF32 off) rather than a (B, N, n_tex)
    temporary."""
    with full_f32_matmul():
        tex = flametex.texture_mean + torch.matmul(
            texcode.to(flametex.texture_basis.dtype), flametex.texture_basis.T)
    tex = tex.reshape(texcode.shape[0], 512, 512, 3)[:, ::2, ::2, :]
    return torch.flip(tex, dims=(-1,))


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """(B, L) x (V, 3, L) → (B, V, 3) (``lbs.py:250-271``)."""
    return torch.einsum("bl,mkl->bmk", betas, shape_disps)


def vertices2joints(j_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) → (B, J, 3) (``lbs.py:230-247``)."""
    return torch.einsum("bik,ji->bjk", vertices, j_regressor)


def _transform_mat(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3, 1) → (..., 4, 4) rigid transforms
    (``lbs.py:308-318``)."""
    top = torch.cat([rot, t], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics over FLAME's 5-joint tree (``lbs.py:321-377``):
    rot_mats (B, J, 3, 3), joints (B, J, 3) → posed joints (B, J, 3) and
    relative transforms (B, J, 4, 4)."""
    rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, list(PARENTS[1:])]], dim=1)
    transforms_mat = _transform_mat(rot_mats, rel_joints[..., None])
    chain = [transforms_mat[:, 0]]
    for i in range(1, NUM_JOINTS):
        chain.append(torch.matmul(chain[PARENTS[i]], transforms_mat[:, i]))
    transforms = torch.stack(chain, dim=1)

    posed_joints = transforms[:, :, :3, 3]
    joints_h = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    tj = torch.einsum("bjmn,bjn->bjm", transforms, joints_h)
    rel = transforms.clone()
    rel[:, :, :3, 3] = transforms[:, :, :3, 3] - tj[:, :, :3]
    return posed_joints, rel


def lbs(betas: torch.Tensor, pose: torch.Tensor, v_template: torch.Tensor,
        shapedirs: torch.Tensor, posedirs: torch.Tensor, j_regressor: torch.Tensor,
        lbs_weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear blend skinning (``lbs.py:140-227``): betas (B, n_shape +
    n_exp), pose (B, J·3) axis-angle → (vertices (B, V, 3), posed joints
    (B, J, 3))."""
    b = betas.shape[0]
    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    joints = vertices2joints(j_regressor, v_shaped)

    rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(b, -1, 3, 3)
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(b, -1)          # (B, 36)
    v_posed = v_shaped + torch.matmul(pose_feature, posedirs).reshape(b, -1, 3)

    posed_joints, rel_transforms = batch_rigid_transform(rot_mats, joints)

    t = torch.einsum("vj,bjmn->bvmn", lbs_weights, rel_transforms)   # (B, V, 4, 4)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvmn,bvn->bvm", t, v_h)[..., :3]
    return verts, posed_joints


def vertices2landmarks(vertices: torch.Tensor, faces: torch.Tensor,
                       lmk_faces_idx: torch.Tensor,
                       lmk_bary_coords: torch.Tensor) -> torch.Tensor:
    """Barycentric landmarks (``lbs.py:101-137``): vertices (B, V, 3),
    faces (F, 3), lmk_faces_idx (B, L) or (L,), lmk_bary_coords (B, L, 3)
    or (L, 3) → (B, L, 3)."""
    b = vertices.shape[0]
    if lmk_faces_idx.dim() == 1:
        lmk_faces_idx = lmk_faces_idx[None].expand(b, -1)
    if lmk_bary_coords.dim() == 2:
        lmk_bary_coords = lmk_bary_coords[None].expand(b, -1, -1)
    lmk_faces = faces[lmk_faces_idx]                                  # (B, L, 3)
    batch = torch.arange(b, device=vertices.device)[:, None, None]
    lmk_vertices = vertices[batch, lmk_faces]                         # (B, L, 3, 3)
    return torch.einsum("blfi,blf->bli", lmk_vertices, lmk_bary_coords.to(vertices.dtype))


def _rot_mat_to_euler_y(rot_mats: torch.Tensor) -> torch.Tensor:
    """atan2(-R[2,0], sqrt(R00² + R10²)) (``lbs.py:26-32``)."""
    sy = torch.sqrt(rot_mats[..., 0, 0] ** 2 + rot_mats[..., 1, 0] ** 2)
    return torch.atan2(-rot_mats[..., 2, 0], sy)


def find_dynamic_lmk_idx(pose: torch.Tensor, dynamic_lmk_faces_idx: torch.Tensor,
                         dynamic_lmk_bary_coords: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The contour's faces and barycentric coordinates from the neck
    chain's rotation (``FLAME.py:93-135``). pose (B, J·3), the full
    axis-angle pose."""
    b = pose.shape[0]
    aa = pose.reshape(b, -1, 3)[:, list(NECK_KIN_CHAIN)]
    rot_mats = batch_rodrigues(aa.reshape(-1, 3)).reshape(b, -1, 3, 3)
    rel = torch.eye(3, dtype=pose.dtype, device=pose.device).expand(b, 3, 3)
    for i in range(len(NECK_KIN_CHAIN)):
        rel = torch.matmul(rot_mats[:, i], rel)

    y_deg = torch.round(torch.clamp(_rot_mat_to_euler_y(rel) * (180.0 / math.pi),
                                    max=39.0)).to(torch.int64)
    neg_vals = torch.where(y_deg < -39, torch.full_like(y_deg, 78), 39 - y_deg)
    idx = torch.where(y_deg < 0, neg_vals, y_deg).detach()
    return dynamic_lmk_faces_idx[idx], dynamic_lmk_bary_coords[idx]


def flame_forward(flame: FLAME, shape_params: torch.Tensor,
                  expression_params: torch.Tensor, pose_params: torch.Tensor,
                  eye_pose_params: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FLAME forward (``FLAME.py:175-214``): shape (B, 100), expression
    (B, 50), pose (B, 6) = [global axis-angle, jaw axis-angle] →
    (vertices (B, V, 3), landmarks2d (B, 68, 3), landmarks3d (B, 68, 3))."""
    b = shape_params.shape[0]
    if eye_pose_params is None:
        eye_pose_params = shape_params.new_zeros((b, 6))
    neck_pose = shape_params.new_zeros((b, 3))
    betas = torch.cat([shape_params, expression_params], dim=1)
    full_pose = torch.cat([pose_params[:, :3], neck_pose, pose_params[:, 3:],
                           eye_pose_params], dim=1)

    verts, _ = lbs(betas, full_pose, flame.v_template, flame.shapedirs, flame.posedirs,
                   flame.j_regressor, flame.lbs_weights)

    dyn_idx, dyn_bary = find_dynamic_lmk_idx(full_pose, flame.dynamic_lmk_faces_idx,
                                             flame.dynamic_lmk_bary_coords)
    lmk_idx = torch.cat([dyn_idx, flame.lmk_faces_idx[None].expand(b, -1)], dim=1)
    lmk_bary = torch.cat([dyn_bary, flame.lmk_bary_coords[None].expand(b, -1, -1)], dim=1)

    landmarks2d = vertices2landmarks(verts, flame.faces, lmk_idx, lmk_bary)
    landmarks3d = select_3d68(flame, verts)
    return verts, landmarks2d, landmarks3d


def select_3d68(flame: FLAME, vertices: torch.Tensor) -> torch.Tensor:
    """The 68 3D landmarks of ``vertices`` (``FLAME.py:169-173``)."""
    return vertices2landmarks(vertices, flame.faces, flame.full_lmk_faces_idx,
                              flame.full_lmk_bary_coords)


def synthetic_flame_params(generator: torch.Generator, n_verts: int = 256,
                           n_faces: int = 400, n_shape: int = 100,
                           n_exp: int = 50) -> Dict[str, torch.Tensor]:
    """Random FLAME arrays of the right shapes and kinds, drawn from
    ``generator`` with the JAX package's distributions (the real
    ``generic_model.pkl`` is licensed separately and not bundled)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator)

    def index(high, *shape):
        return torch.randint(0, high, shape, generator=generator)

    def simplex(*shape):
        return torch.softmax(normal(*shape), dim=-1)

    return {
        "v_template": normal(n_verts, 3) * 0.1,
        "shapedirs": normal(n_verts, 3, n_shape + n_exp) * 0.01,
        "posedirs": normal(36, n_verts * 3) * 0.01,
        "j_regressor": simplex(NUM_JOINTS, n_verts),
        "lbs_weights": simplex(n_verts, NUM_JOINTS),
        "faces": index(n_verts, n_faces, 3),
        "lmk_faces_idx": index(n_faces, 51),
        "lmk_bary_coords": simplex(51, 3),
        "dynamic_lmk_faces_idx": index(n_faces, 79, 17),
        "dynamic_lmk_bary_coords": simplex(79, 17, 3),
        "full_lmk_faces_idx": index(n_faces, 68),
        "full_lmk_bary_coords": simplex(68, 3),
    }
