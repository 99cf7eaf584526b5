"""The port's DECA mesh export and visualization grid
(``models/deca/mesh_io.py``) against the JAX package's on the same arrays:
every file either writes is compared byte for byte, and every array
exactly. The port is handed torch tensors (its decode's outputs are
tensors), the JAX package the same values as numpy arrays. Inputs are made
with numpy from seeds.
"""

import os

import numpy as np
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.models.deca import mesh_io as jm

from stylegan_directions_face_reenactment_tpu_torch.models.deca import mesh_io as pm
from torch_threads import _threads  # noqa: F401

NV, NF, UV, NUV = 17, 24, 16, 11


def tensors(tree):
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)) if isinstance(tree, np.ndarray) else tree


def same_files(a, b):
    """The two directories hold the same file names with the same bytes
    (the .mtl names its normal map by the path given, as the reference's
    writer does, so a's directory reads as b's)."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            assert fa.read().replace(str(a).encode(), str(b).encode()) == fb.read(), n


def dirs(tmp_path):
    out = (tmp_path / "jax", tmp_path / "port")
    for d in out:
        d.mkdir()
    return out


def mesh(seed):
    rng = np.random.default_rng(seed)
    verts = rng.standard_normal((NV, 3)).astype(np.float32)
    faces = rng.integers(0, NV, (NF, 3)).astype(np.int64)
    return rng, verts, faces


def dense_template(rng, nv=NV, uv=UV, npix=40, nf_dense=30):
    return {"img_size": uv,
            "f": rng.integers(0, npix, (nf_dense, 3)).astype(np.int64),
            "x_coords": rng.integers(0, uv, (uv * uv,)).astype(np.float64),
            "y_coords": rng.integers(0, uv, (uv * uv,)).astype(np.float64),
            "valid_pixel_ids": rng.choice(uv * uv, npix, replace=False),
            "valid_pixel_3d_faces": rng.integers(0, nv, (npix, 3)).astype(np.int64),
            "valid_pixel_b_coords": rng.dirichlet(np.ones(3), npix)}


@pytest.mark.parametrize("case", ["untextured", "colors_inverse", "textured"])
def test_write_obj_matches_jax(tmp_path, case):
    rng, verts, faces = mesh(0)
    kw = {}
    if case == "colors_inverse":
        kw = {"colors": rng.random((NV, 3)).astype(np.float32), "inverse_face_order": True}
    if case == "textured":
        kw = {"texture": rng.integers(0, 256, (UV, UV, 3)).astype(np.uint8),
              "uvcoords": rng.random((NUV, 2)).astype(np.float32),
              "uvfaces": rng.integers(0, NUV, (NF, 3)).astype(np.int64),
              "normal_map": rng.integers(0, 256, (UV, UV, 3)).astype(np.uint8)}
    j, p = dirs(tmp_path)
    jm.write_obj(str(j / "mesh.obj"), verts, faces, **kw)
    pm.write_obj(str(p / "mesh"), torch.from_numpy(verts), torch.from_numpy(faces),
                 **tensors(kw))
    same_files(j, p)


def test_upsample_mesh_matches_jax():
    rng, verts, faces = mesh(3)
    normals = rng.standard_normal(verts.shape).astype(np.float32)
    disp = rng.standard_normal((UV, UV)).astype(np.float32)
    tex = rng.integers(0, 256, (UV, UV, 3)).astype(np.uint8)
    tmpl = dense_template(rng)
    want = jm.upsample_mesh(verts, normals, faces, disp, tex, tmpl)
    got = pm.upsample_mesh(*(torch.from_numpy(a) for a in (verts, normals, faces, disp, tex)),
                           tmpl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _opdict(rng, with_dense=True):
    op = {"vertices": rng.standard_normal((2, NV, 3)).astype(np.float32),
          "uv_texture_gt": rng.random((2, UV, UV, 3)).astype(np.float32),
          "uv_detail_normals": rng.uniform(-1, 1, (2, UV, UV, 3)).astype(np.float32)}
    if with_dense:
        op["normals"] = rng.standard_normal((2, NV, 3)).astype(np.float32)
        op["displacement_map"] = rng.standard_normal((2, UV, UV, 1)).astype(np.float32)
    return op


@pytest.mark.parametrize("with_dense", [True, False])
def test_save_obj_matches_jax(tmp_path, with_dense):
    rng, _, faces = mesh(4)
    op = _opdict(rng, with_dense)
    uvcoords = rng.random((NUV, 2)).astype(np.float32)
    uvfaces = rng.integers(0, NUV, (NF, 3)).astype(np.int64)
    tmpl = dense_template(rng) if with_dense else None
    j, p = dirs(tmp_path)
    # batched topology, as decode_deca's FLAME faces are broadcast; the second frame
    jm.save_obj(str(j / "face.obj"), op, faces[None], uvcoords, uvfaces,
                dense_template=tmpl, index=1)
    pm.save_obj(str(p / "face"), tensors(op), torch.from_numpy(faces)[None],
                torch.from_numpy(uvcoords), torch.from_numpy(uvfaces), dense_template=tmpl,
                index=1)
    same_files(j, p)
    assert os.path.exists(p / "face_detail.obj") == with_dense


def test_save_ply_matches_jax(tmp_path):
    rng, verts, faces = mesh(6)
    j, p = dirs(tmp_path)
    jm.save_ply(str(j / "face.ply"), {"vertices": verts[None]}, faces)
    pm.save_ply(str(p / "face.ply"), {"vertices": torch.from_numpy(verts)[None]},
                torch.from_numpy(faces))
    same_files(j, p)


def test_visualize_and_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    visdict = {"inputs": rng.random((3, 12, 12, 3)).astype(np.float32),
               "shape_images": rng.random((3, 8, 8, 3)).astype(np.float32) * 1.2 - 0.1,
               "landmarks2d": rng.random((3, 17, 17, 3)).astype(np.float32)}
    for size in (10, 24):
        np.testing.assert_array_equal(pm.visualize(tensors(visdict), size=size),
                                      jm.visualize(visdict, size=size))
    batch = visdict["inputs"]
    for size in (5, 17):
        np.testing.assert_array_equal(pm._resize_nearest(batch, size),
                                      jm._resize_nearest(batch, size))
    np.testing.assert_array_equal(pm._make_grid(batch, nrow=2, padding=3),
                                  jm._make_grid(batch, nrow=2, padding=3))
    img = visdict["shape_images"][0]
    np.testing.assert_array_equal(pm.to_image_u8(torch.from_numpy(img)), jm.to_image_u8(img))
    path = str(tmp_path / "dense.npy")
    np.save(path, dense_template(rng), allow_pickle=True)
    want, got = jm.load_dense_template(path), pm.load_dense_template(path)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
