"""The port's Δp direction space and direction matrix A against the JAX
package's on the CPU. Tolerance: rtol 1e-5, atol 1e-5 (float32 affine maps
and one 15-wide matmul)."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.geometry.directions import (
    initialize_directions as j_initialize_directions,
    make_shift_vector as j_make_shift_vector,
    start_positions as j_start_positions)
from stylegan_directions_face_reenactment_tpu.models.direction_matrix import (
    direction_matrix_forward as j_direction_matrix_forward, init_direction_matrix)

import stylegan_directions_face_reenactment_tpu as jax_pkg
import stylegan_directions_face_reenactment_tpu_torch as port_pkg
from stylegan_directions_face_reenactment_tpu_torch.geometry import (
    initialize_directions, make_shift_vector, start_positions)
from stylegan_directions_face_reenactment_tpu_torch.models import (
    direction_matrix_forward)
from stylegan_directions_face_reenactment_tpu_torch.weights import (
    direction_matrix_from_jax, init_direction_matrix as p_init_direction_matrix)
from torch_threads import _threads  # noqa: F401


def _coeffs(rs, b):
    return {"pose": (rs.randn(b, 6) * 0.2).astype(np.float32),
            "alpha_exp": rs.randn(b, 50).astype(np.float32),
            "alpha_shp": rs.randn(b, 100).astype(np.float32),
            "cam": rs.randn(b, 3).astype(np.float32)}


@pytest.mark.parametrize("name,ranges", [("voxceleb", "ranges_voxceleb.npy"),
                                         ("ffhq", "ranges_FFHQ.npy")])
def test_ranges_files_are_copies(name, ranges):
    jdir = os.path.join(os.path.dirname(jax_pkg.__file__), "configs")
    pdir = os.path.join(os.path.dirname(port_pkg.__file__), "configs")
    with open(os.path.join(jdir, ranges), "rb") as a, \
            open(os.path.join(pdir, ranges), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["voxceleb", "ffhq"])
def test_initialize_directions_matches_jax(name):
    got = dataclasses.asdict(initialize_directions(name, 15, 6.0))
    want = dataclasses.asdict(j_initialize_directions(name, 15, 6.0))
    assert got == want


@pytest.mark.parametrize("name", ["voxceleb", "ffhq"])
def test_make_shift_vector_matches_jax(name):
    rs = np.random.RandomState(0)
    spec_j = j_initialize_directions(name, 15, 6.0)
    spec = initialize_directions(name, 15, 6.0)
    ps, pt = _coeffs(rs, 4), _coeffs(rs, 4)
    a_s = rs.uniform(-60, 60, (4, 3)).astype(np.float32)
    a_t = rs.uniform(-60, 60, (4, 3)).astype(np.float32)
    tj = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    want = j_make_shift_vector(spec_j, tj(ps), tj(pt), jnp.asarray(a_s), jnp.asarray(a_t))
    got = make_shift_vector(spec, tt(ps), tt(pt), torch.from_numpy(a_s),
                            torch.from_numpy(a_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        start_positions(spec, tt(pt), torch.from_numpy(a_t)).numpy(),
        np.asarray(j_start_positions(spec_j, tj(pt), jnp.asarray(a_t))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("w_plus", [True, False])
def test_direction_matrix_matches_jax(w_plus):
    p = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x,
        init_direction_matrix(jax.random.PRNGKey(1), 512, 15, w_plus=w_plus,
                              num_layers=8))
    p["bias"] = np.random.RandomState(2).randn(*p["bias"].shape).astype(np.float32)
    a = direction_matrix_from_jax(p, device="cpu")
    dp = np.random.RandomState(3).randn(3, 15).astype(np.float32)
    want = j_direction_matrix_forward(p, jnp.asarray(dp))
    with torch.no_grad():
        got = direction_matrix_forward(a, torch.from_numpy(dp))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_seeded_direction_matrix_init():
    a = p_init_direction_matrix(4, device="cpu")
    w = a.linear.weight.detach()
    assert w.shape == (8 * 512, 15)
    assert 0.025 < float(w.std()) < 0.035
    assert float(a.linear.bias.detach().abs().max()) == 0.0
