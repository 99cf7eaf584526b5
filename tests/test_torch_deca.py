"""The port's DECA encode side and rotation chain against the JAX
package's on the CPU.

A random-init JAX ``e_flame`` encoder (ResNet-50 + MLP), with batch-norm
statistics randomized so that the folded normalization is exercised, goes
across with ``weights/from_jax.py``; images are made with numpy from a seed.

Tolerances: coefficients rtol 1e-3, atol 1e-3·max|coefficient|, the bound
of the repo's torch-vs-JAX DECA encoder parity test (float32 sums over 53
convolutions in another order); angles atol 1e-2 degrees, because asin and
atan2 near ±90° pitch amplify the last digits of the pose.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.geometry.rotations import (
    batch_axis2euler as j_batch_axis2euler, batch_euler2axis as j_batch_euler2axis)
from stylegan_directions_face_reenactment_tpu.models.deca.deca import (
    calculate_shapemodel as j_calculate_shapemodel, init_resnet_encoder)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_resnet_encoder)

from stylegan_directions_face_reenactment_tpu_torch.geometry.rotations import (
    batch_axis2euler, batch_euler2axis, deg2rad, rad2deg)
from stylegan_directions_face_reenactment_tpu_torch.models.deca import (
    calculate_shapemodel, deca_encode)
from stylegan_directions_face_reenactment_tpu_torch.weights import (
    deca_from_jax, init_deca)
from torch_threads import _threads  # noqa: F401


def to_np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _randomize_bn(tree, rs):
    if isinstance(tree, dict):
        if set(tree) == {"scale", "offset", "mean", "var"}:
            c = tree["mean"].shape[0]
            tree["scale"] = (1.0 + 0.1 * rs.randn(c)).astype(np.float32)
            tree["offset"] = (0.1 * rs.randn(c)).astype(np.float32)
            tree["mean"] = (0.1 * rs.randn(c)).astype(np.float32)
            tree["var"] = (0.5 + rs.rand(c)).astype(np.float32)
        else:
            for v in tree.values():
                _randomize_bn(v, rs)
    elif isinstance(tree, list):
        for v in tree:
            _randomize_bn(v, rs)


@pytest.fixture(scope="module")
def decas():
    e = to_np(init_resnet_encoder(jax.random.PRNGKey(0), 236))
    _randomize_bn(e, np.random.RandomState(1))
    p = {"e_flame": e}
    return p, deca_from_jax(p, device="cpu")


def close_coeffs(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * scale)


@pytest.mark.parametrize("image_space,in_size,image_size", [
    ("gan", 48, 64),      # bilinear upsample to the DECA size
    ("255", 80, 64),      # [0, 255] input, bilinear downsample
    ("gan", 256, 224),    # the serving shapes: 256 → 224
])
def test_calculate_shapemodel_matches_jax(decas, image_space, in_size, image_size):
    p, d = decas
    rs = np.random.RandomState(2)
    lo, hi = (-1.0, 1.0) if image_space == "gan" else (0.0, 255.0)
    x = rs.uniform(lo, hi, (2, in_size, in_size, 3)).astype(np.float32)
    want_p, want_a = jax.jit(lambda im: j_calculate_shapemodel(
        p, im, image_space=image_space, image_size=image_size))(jnp.asarray(x))
    with torch.no_grad():
        got_p, got_a = calculate_shapemodel(d, torch.from_numpy(x),
                                            image_space=image_space,
                                            image_size=image_size)
    assert set(got_p) == {"pose", "alpha_shp", "alpha_exp", "cam"}
    for k in want_p:
        assert got_p[k].dtype == torch.float32
        close_coeffs(got_p[k].numpy(), want_p[k])
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=0, atol=1e-2)


def test_bf16_trunk_returns_f32_coefficients(decas):
    _, d = decas
    x = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        f32, _ = calculate_shapemodel(d, x, image_size=32)
        bf16, ang = calculate_shapemodel(d, x, image_size=32,
                                         compute_dtype=torch.bfloat16)
    assert ang.dtype == torch.float32
    for k in f32:
        assert bf16[k].dtype == torch.float32
        rel = float((bf16[k] - f32[k]).abs().max() / f32[k].abs().max())
        assert rel < 0.1, (k, rel)


def test_state_dict_keeps_the_reference_key_layout(decas):
    """The port's ``E_flame`` state_dict goes through the JAX package's
    converter for reference DECA checkpoints and gives back the pytree."""
    p, d = decas
    back = to_np(convert_resnet_encoder(d.E_flame.state_dict()))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(p["e_flame"]):
        if isinstance(leaf, np.ndarray):
            np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)
            n += 1
    assert n == sum(isinstance(v, np.ndarray) for v in flat_b.values())


def test_seeded_init_encodes_finite():
    d = init_deca(5, device="cpu")
    x = torch.rand(1, 32, 32, 3)
    with torch.no_grad():
        code = deca_encode(d, x)
    assert code["shape"].shape == (1, 100) and code["light"].shape == (1, 9, 3)
    assert all(torch.isfinite(v).all() for v in code.values())


def test_rotation_chain_matches_jax():
    """Euler → axis and axis → euler (through the matrix), including
    near-gimbal-lock pitches; compared in degrees."""
    rs = np.random.RandomState(4)
    eul = rs.uniform(-80, 80, (64, 3)).astype(np.float32)
    eul[:4, 0] = [89.5, -89.5, 89.95, -89.99]
    aa_want = np.asarray(j_batch_euler2axis(jnp.asarray(np.deg2rad(eul))))
    aa = batch_euler2axis(deg2rad(torch.from_numpy(eul)))
    np.testing.assert_allclose(aa.numpy(), aa_want, rtol=1e-5, atol=1e-5)
    back_want = np.rad2deg(np.asarray(j_batch_axis2euler(jnp.asarray(aa_want))))
    back = rad2deg(batch_axis2euler(torch.from_numpy(aa_want.copy())))
    np.testing.assert_allclose(back.numpy(), back_want, rtol=0, atol=1e-2)
