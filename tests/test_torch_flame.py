"""The port's FLAME decode (``models/deca/flame.py``, ``deca.py::
{deca_decode, calculate_shape}``, ``weights/flame_loader.py``) and the
rotations it needs, against the JAX package on the CPU.

Inputs: the JAX package's ``synthetic_flame_params`` carried into the port
with ``flame_from_jax``; coefficients made with numpy from a seed (poses of
±0.3 rad, so the contour table's index moves between samples). Tolerance:
rtol 1e-5, atol 1e-5·max|JAX output|; the contour table's indices exactly.
The reference's own outputs (``tests/goldens/flame.npz``) at the
tolerances of ``tests/test_flame_deca.py``; the FLAME files of
``tests/torch_cli_files.py`` through both loaders, exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.geometry import rotations as jr
from stylegan_directions_face_reenactment_tpu.models.deca import deca as jd
from stylegan_directions_face_reenactment_tpu.models.deca import flame as jf
from stylegan_directions_face_reenactment_tpu.weights.flame_loader import (
    load_flame_params as j_load_flame_params)

from stylegan_directions_face_reenactment_tpu_torch.geometry import rotations as pr
from stylegan_directions_face_reenactment_tpu_torch.models.deca import deca as pd
from stylegan_directions_face_reenactment_tpu_torch.models.deca import flame as pf
from stylegan_directions_face_reenactment_tpu_torch.weights import (
    flame_from_jax, init_deca, load_flame_params)

from torch_cli_files import write_flame
from torch_face_zoo import to_np
from torch_threads import _threads  # noqa: F401

B = 4
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "flame.npz")


@pytest.fixture(scope="module")
def flames():
    j = to_np(jax.jit(jf.synthetic_flame_params)(jax.random.PRNGKey(3)))
    return j, flame_from_jax(j, device="cpu")


@pytest.fixture(scope="module")
def coeffs():
    rs = np.random.RandomState(0)
    return {"shape": rs.randn(B, 100).astype(np.float32),
            "exp": rs.randn(B, 50).astype(np.float32),
            "pose": (0.3 * rs.randn(B, 6)).astype(np.float32),
            "cam": np.abs(rs.randn(B, 3)).astype(np.float32) + 1.0}


def close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def t(a):
    return torch.from_numpy(np.array(a))


def _rotation_cases():
    rs = np.random.RandomState(1)
    aa = (rs.randn(8, 3) * 0.8).astype(np.float32)
    euler = (rs.randn(8, 3) * 0.5).astype(np.float32)
    mats = np.asarray(jr.batch_euler2matrix(jnp.asarray(euler)))
    pts = rs.randn(2, 5, 3).astype(np.float32)
    cam = rs.rand(2, 3).astype(np.float32)
    return {"batch_rodrigues": (aa,), "batch_euler2matrix": (euler,),
            "rotation_matrix_to_quaternion": (mats,), "batch_matrix2axis": (mats,),
            "batch_orth_proj": (pts, cam)}


@pytest.mark.parametrize("name", list(_rotation_cases()))
def test_rotations_match_jax(name):
    args = _rotation_cases()[name]
    want = getattr(jr, name)(*(jnp.asarray(a) for a in args))
    close(getattr(pr, name)(*(t(a) for a in args)), want)


def test_lbs_matches_jax(flames, coeffs):
    j, p = flames
    betas = np.concatenate([coeffs["shape"], coeffs["exp"]], 1)
    pose = (0.3 * np.random.RandomState(2).randn(B, 15)).astype(np.float32)
    keys = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights")
    want = jf.lbs(jnp.asarray(betas), jnp.asarray(pose), *(jnp.asarray(j[k]) for k in keys))
    got = pf.lbs(t(betas), t(pose), *(getattr(p, k) for k in keys))
    for g, w in zip(got, want):
        close(g, w)


def test_vertices2landmarks_matches_jax(flames):
    j, p = flames
    verts = np.random.RandomState(4).randn(B, 256, 3).astype(np.float32)
    idx = np.random.RandomState(5).randint(0, 400, (B, 51))
    want = jf.vertices2landmarks(jnp.asarray(verts), jnp.asarray(j["faces"]),
                                 jnp.asarray(idx), jnp.asarray(j["lmk_bary_coords"]))
    close(pf.vertices2landmarks(t(verts), p.faces, t(idx), p.lmk_bary_coords), want)


def test_find_dynamic_lmk_idx_matches_jax(flames):
    j, p = flames
    pose = (0.6 * np.random.RandomState(6).randn(16, 15)).astype(np.float32)
    want_idx, want_bary = jf.find_dynamic_lmk_idx(
        jnp.asarray(pose), jnp.asarray(j["dynamic_lmk_faces_idx"]),
        jnp.asarray(j["dynamic_lmk_bary_coords"]))
    got_idx, got_bary = pf.find_dynamic_lmk_idx(t(pose), p.dynamic_lmk_faces_idx,
                                                p.dynamic_lmk_bary_coords)
    assert len(np.unique(np.asarray(want_idx)[:, 0])) > 1
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    close(got_bary, want_bary)


def test_flame_forward_matches_jax(flames, coeffs):
    j, p = flames
    want = jf.flame_forward(j, *(jnp.asarray(coeffs[k]) for k in ("shape", "exp", "pose")))
    got = pf.flame_forward(p, *(t(coeffs[k]) for k in ("shape", "exp", "pose")))
    for g, w in zip(got, want):
        close(g, w)
    close(pf.select_3d68(p, got[0]), want[2])


def test_deca_decode_matches_jax(flames, coeffs):
    j, p = flames
    want = jd.calculate_shape({"flame": j}, {k: jnp.asarray(v) for k, v in coeffs.items()})
    deca = pd.DECA(p)
    got = pd.calculate_shape(deca, {k: t(v) for k, v in coeffs.items()})
    for g, w in zip(got, want):
        close(g, w)
    for g, w in zip(pd.deca_decode(deca, {k: t(v) for k, v in coeffs.items()}, 112),
                    jd.deca_decode({"flame": j}, {k: jnp.asarray(v) for k, v in coeffs.items()},
                                   112)):
        close(g, w)


def test_landmark_gradient_matches_jax(flames, coeffs):
    """d(sum of the projected 2D landmarks · a fixed projection)/d(pose,
    exp), through LBS and the barycentric gather."""
    j, p = flames
    proj = np.random.RandomState(7).randn(B, 68, 2).astype(np.float32)

    jflame = {"flame": jax.tree_util.tree_map(jnp.asarray, j)}

    def j_loss(pose, exp):
        cd = {"shape": jnp.asarray(coeffs["shape"]), "exp": exp, "pose": pose,
              "cam": jnp.asarray(coeffs["cam"])}
        return jnp.sum(jd.deca_decode(jflame, cd)[0] * proj)

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(coeffs["pose"]),
                                                     jnp.asarray(coeffs["exp"]))
    pose, exp = t(coeffs["pose"]).requires_grad_(), t(coeffs["exp"]).requires_grad_()
    cd = {"shape": t(coeffs["shape"]), "exp": exp, "pose": pose, "cam": t(coeffs["cam"])}
    (pd.deca_decode(pd.DECA(p), cd)[0] * t(proj)).sum().backward()
    for g, w in zip((pose.grad, exp.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("part", ["rodrigues", "lbs", "landmarks", "dynamic"])
def test_matches_reference_goldens(golden, part):
    g = golden
    if part == "rodrigues":
        np.testing.assert_allclose(pr.batch_rodrigues(t(g["aa"])).numpy(), g["rod"],
                                   rtol=1e-5, atol=1e-6)
    elif part == "lbs":
        verts, joints = pf.lbs(*(t(g[k]) for k in ("betas", "full_pose", "v_template",
                                                   "shapedirs", "posedirs", "j_regressor",
                                                   "lbs_weights")))
        np.testing.assert_allclose(verts.numpy(), g["verts"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(joints.numpy(), g["joints"], rtol=1e-4, atol=1e-5)
    elif part == "landmarks":
        lmks = pf.vertices2landmarks(t(g["verts"]), t(g["faces"]).long(),
                                     t(g["lmk_faces_idx"]).long(), t(g["lmk_bary"]))
        np.testing.assert_allclose(lmks.numpy(), g["lmks"], rtol=1e-4, atol=1e-5)
    else:
        idx, bary = pf.find_dynamic_lmk_idx(t(g["full_pose"]), t(g["dyn_faces"]).long(),
                                            t(g["dyn_bary"]))
        np.testing.assert_array_equal(idx.numpy(), g["dyn_idx_sel"])
        np.testing.assert_allclose(bary.numpy(), g["dyn_bary_sel"], rtol=1e-5)


def test_load_flame_params_matches_jax(tmp_path):
    write_flame(str(tmp_path))
    files = (str(tmp_path / "generic_model.pkl"), str(tmp_path / "landmark_embedding.npy"))
    want = to_np(j_load_flame_params(*files))
    got = load_flame_params(*files)
    assert set(want) == set(pf.FLOAT_KEYS + pf.INDEX_KEYS)
    for k, w in want.items():
        g = getattr(got, k)
        assert g.dtype == (torch.int64 if k in pf.INDEX_KEYS else torch.float32), k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


def test_flame_stays_out_of_the_state_dict():
    """``init_deca``'s FLAME is at the real model's sizes, on the DECA
    module's device, and out of its state dict: the checkpoint's key
    layout (``E_flame.*``) is unchanged."""
    deca = init_deca(0, device="cpu")
    assert tuple(deca.flame.v_template.shape) == (5023, 3)
    assert tuple(deca.flame.faces.shape) == (9976, 3)
    assert all(k.startswith("E_flame.") for k in deca.state_dict())
    assert deca.state_dict().keys() == pd.DECA().state_dict().keys()
    lm2d, lm3d, verts = pd.deca_decode(deca, {
        "shape": torch.zeros(2, 100), "exp": torch.zeros(2, 50),
        "pose": torch.zeros(2, 6), "cam": torch.tensor([[8.0, 0.0, 0.0]] * 2)})
    assert lm2d.shape == (2, 68, 2) and lm3d.shape == (2, 68, 3) and verts.shape == (2, 5023, 3)
    assert all(bool(torch.isfinite(x).all()) for x in (lm2d, lm3d, verts))
