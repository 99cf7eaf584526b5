"""Frame data parallelism (``mesh=``) on both reenactment entry points,
against ``mesh=None`` and against the JAX package's entry points on the
same inputs. The set-up is ``tests/torch_reenact_world.py`` (T = 2 raw
frames of 256², a 64² generator, a 2-module FAN, a boosted S3FD so that
every face passes the gate); the mesh is two CPU slots
(``make_mesh(2, device="cpu")``), a frame a slot.

Tolerances (those of ``tests/test_torch_raw_reenact.py``): ok, in_frame
and landmarks equal; crops at most 1 intensity unit; images rtol 1e-3,
atol 2e-4·max|image|; latents rtol 1e-4, atol 1e-4·max|latent|. Against
``mesh=None`` the same limits: a batch of one and of two may sum in other
orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.geometry.directions import (
    initialize_directions as j_initialize_directions)
from stylegan_directions_face_reenactment_tpu.pipeline.reenactment import (
    make_fused_reenact_fn as j_make_fused_reenact_fn, reenact_batch as j_reenact_batch)

from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
from stylegan_directions_face_reenactment_tpu_torch.parallel import make_mesh
from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
    make_fused_reenact_fn, make_reenact_fn)

from torch_face_zoo import statics_jit
from torch_reenact_world import T, build_world, close_scaled

SPEC = initialize_directions("voxceleb", 15, 6.0)


@pytest.fixture(scope="module")
def world():
    w = build_world()
    w["mesh"] = make_mesh(2, device="cpu")
    return w


def check_full(got, want):
    """The fused path's full outputs against another run's."""
    reen, lat, crops, ok, inf, pts = (np.asarray(x) for x in got)
    reen_w, lat_w, crops_w, ok_w, inf_w, pts_w = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(ok, ok_w)
    np.testing.assert_array_equal(inf, inf_w)
    np.testing.assert_array_equal(pts, pts_w)
    assert np.abs(crops.astype(int) - crops_w.astype(int)).max() <= 1
    close_scaled(lat, lat_w, 1e-4, 1e-4)
    close_scaled(reen, reen_w, 1e-3, 2e-4)


@pytest.fixture(scope="module")
def fused(world):
    """(the port's fused outputs over the mesh, without it, the JAX
    package's)."""
    g, a, deca, pf, ps = world["port"]
    args = (world["code"], world["ps"], world["ang"], world["frames"])
    out = []
    for mesh in (world["mesh"], None):
        fn = make_fused_reenact_fn(g, a, deca, SPEC, ps, pf, truncation_latent=world["trunc"],
                                   fan_params=pf, s3fd_params=ps, mesh=mesh, device="cpu")
        out.append([o.numpy() for o in fn(*args)])
    jg, ja, jdeca, jf, js = world["jax"]
    jfn = j_make_fused_reenact_fn(jg, ja, jdeca, j_initialize_directions("voxceleb", 15, 6.0),
                                  js, jf, truncation_latent=jnp.asarray(world["trunc"]),
                                  fan_params=jf, s3fd_params=js)
    out.append([np.asarray(o) for o in jfn(world["code"], world["ps"], world["ang"],
                                           jnp.asarray(world["frames"]))])
    return out


def test_fused_mesh_matches_one_device(fused):
    mesh_out, one, _ = fused
    assert mesh_out[0].shape[0] == T and mesh_out[3].all()
    check_full(mesh_out, one)


def test_fused_mesh_matches_jax(fused):
    check_full(fused[0], fused[2])


def test_reenact_fn_mesh_matches_one_device_and_jax(world, fused):
    """``make_reenact_fn`` with the SFD → FAN alignment on the fused
    path's crops (the JAX package's, in [-1, 1])."""
    g, a, deca, pf, ps = world["port"]
    crops = fused[2][2].astype(np.float32) / 127.5 - 1.0
    args = (world["code"], world["ps"], world["ang"], crops)
    kw = dict(truncation_latent=torch.from_numpy(world["trunc"]), fan_params=pf,
              s3fd_params=ps, device="cpu")
    img, lat = make_reenact_fn(g, a, deca, SPEC, mesh=world["mesh"], **kw)(*args)
    one_img, one_lat = make_reenact_fn(g, a, deca, SPEC, **kw)(*args)
    jg, ja, jdeca, jf, js = world["jax"]
    jspec = j_initialize_directions("voxceleb", 15, 6.0)
    want_img, want_lat = statics_jit(
        lambda g, a, deca, f, s, *xs: j_reenact_batch(
            g, a, deca, jspec, *xs, truncation=0.7,
            truncation_latent=jnp.asarray(world["trunc"]), fan_params=f, s3fd_params=s),
        jg, ja, jdeca, jf, js)(*args)
    for w_img, w_lat in ((one_img.numpy(), one_lat.numpy()),
                         (np.asarray(want_img), np.asarray(want_lat))):
        close_scaled(lat, w_lat, 1e-4, 1e-4)
        close_scaled(img, w_img, 1e-3, 2e-4)
