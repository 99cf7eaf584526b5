"""The port's ``reenact_batch`` / ``make_reenact_fn`` with the DECA face
alignment against the JAX package on the CPU: the SFD → FAN chain on the
target crops, and the reuse-landmarks mode (``target_lms``, ``target_ok``).
The set-up is ``tests/torch_reenact_world.py``; the targets are 256² crops
in [-1, 1] made with numpy from a seed.

Tolerances: target coefficients rtol 1e-3, atol 1e-3·max|coefficient|
(the DECA encoder bound); angles atol 1e-2 degrees; latents rtol 1e-4,
atol 1e-4·max|latent|; images rtol 1e-3, atol 2e-4·max|image| (the
bounds of ``tests/test_torch_reenact.py``). The landmarks inside the alignment must agree exactly for these
to hold.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.geometry.directions import (
    initialize_directions as j_initialize_directions)
from stylegan_directions_face_reenactment_tpu.pipeline.reenactment import (
    reenact_batch as j_reenact_batch)

from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
    make_fused_reenact_fn, make_reenact_fn, reenact_batch)

from torch_face_zoo import statics_jit
from torch_reenact_world import SIZE, T, build_world, close_scaled
from torch_threads import _threads  # noqa: F401


@pytest.fixture(scope="module")
def world():
    w = build_world()
    rs = np.random.RandomState(9)
    w["tgts"] = rs.uniform(-1, 1, (T, 256, 256, 3)).astype(np.float32)
    w["lms"] = (rs.rand(T, 68, 2) * 110 + 70).astype(np.float32)
    w["ok"] = np.array([True, False])
    return w


def _jax(world, mode):
    g, a, deca, jf, js = world["jax"]
    spec = j_initialize_directions("voxceleb", 15, 6.0)
    kw = dict(truncation=0.7, truncation_latent=jnp.asarray(world["trunc"]),
              return_target_params=True)
    if mode == "reuse":
        fn = statics_jit(lambda g, a, deca, c, p, an, tg, lm, ok: j_reenact_batch(
            g, a, deca, spec, c, p, an, tg, target_lms=lm, target_ok=ok, **kw), g, a, deca)
        out = fn(world["code"], world["ps"], world["ang"], world["tgts"],
                 world["lms"], world["ok"])
    else:
        fn = statics_jit(lambda g, a, deca, jf, js, c, p, an, tg: j_reenact_batch(
            g, a, deca, spec, c, p, an, tg, fan_params=jf, s3fd_params=js, **kw),
            g, a, deca, jf, js)
        out = fn(world["code"], world["ps"], world["ang"], world["tgts"])
    return jax.tree_util.tree_map(np.asarray, out)


def _port(world, mode):
    g, a, deca, pf, ps = world["port"]
    t = torch.from_numpy
    kw = {"target_lms": t(world["lms"]), "target_ok": t(world["ok"])} if mode == "reuse" \
        else {"fan_params": pf, "s3fd_params": ps}
    with torch.no_grad():
        return reenact_batch(
            g, a, deca, initialize_directions("voxceleb", 15, 6.0), t(world["code"]),
            {k: t(v) for k, v in world["ps"].items()}, t(world["ang"]), t(world["tgts"]),
            truncation=0.7, truncation_latent=t(world["trunc"]),
            return_target_params=True, **kw)


@pytest.mark.parametrize("mode", ["sfd", "reuse"])
def test_reenact_batch_alignment_matches_jax(world, mode):
    want_img, want_lat, want_p, want_a = _jax(world, mode)
    img, lat, pt, at = _port(world, mode)
    if mode == "reuse":          # frame 1 is flagged: the −180° sentinel
        assert (at[1] == -180.0).all() and (pt["pose"][1] == 0).all()
    else:                        # the boosted detector passes every frame
        assert (at != -180.0).all()
    for k in want_p:
        close_scaled(pt[k].numpy(), want_p[k], 1e-3, 1e-3)
    np.testing.assert_allclose(at.numpy(), want_a, rtol=0, atol=1e-2)
    close_scaled(lat.numpy(), want_lat, 1e-4, 1e-4)
    close_scaled(img.numpy(), want_img, 1e-3, 2e-4)
    assert img.shape == (T, SIZE, SIZE, 3)


@pytest.mark.parametrize("mode", ["sfd", "reuse"])
def test_make_reenact_fn_alignment_on_cpu(world, mode):
    """The entry point: numpy in, the same tensors as reenact_batch out; in
    reuse mode it takes target_lms and target_ok after the images."""
    g, a, deca, pf, ps = world["port"]
    spec = initialize_directions("voxceleb", 15, 6.0)
    args = (world["code"], world["ps"], world["ang"], world["tgts"])
    if mode == "reuse":
        fn = make_reenact_fn(g, a, deca, spec, truncation_latent=torch.from_numpy(world["trunc"]),
                             reuse_landmarks=True, device="cpu")
        img, lat = fn(*args, world["lms"], world["ok"])
        with pytest.raises(TypeError):
            fn(*args)
    else:
        fn = make_reenact_fn(g, a, deca, spec, truncation_latent=torch.from_numpy(world["trunc"]),
                             fan_params=pf, s3fd_params=ps, device="cpu")
        img, lat = fn(*args)
    want_img, want_lat = _port(world, mode)[:2]
    torch.testing.assert_close(img, want_img, rtol=0, atol=0)
    torch.testing.assert_close(lat, want_lat, rtol=0, atol=0)


def test_mesh_over_two_cpu_slots(world):
    """``mesh=`` on the SFD → FAN chain: two CPU slots, a frame each,
    equal to the one-device call at this file's limits; a frame batch
    that does not divide the mesh raises, on either entry point."""
    from stylegan_directions_face_reenactment_tpu_torch.parallel import make_mesh
    g, a, deca, pf, ps = world["port"]
    spec = initialize_directions("voxceleb", 15, 6.0)
    kw = dict(truncation_latent=torch.from_numpy(world["trunc"]), fan_params=pf,
              s3fd_params=ps, device="cpu")
    args = (world["code"], world["ps"], world["ang"], world["tgts"])
    img, lat = make_reenact_fn(g, a, deca, spec, mesh=make_mesh(2, device="cpu"), **kw)(*args)
    want_img, want_lat = make_reenact_fn(g, a, deca, spec, **kw)(*args)
    close_scaled(lat, want_lat.numpy(), 1e-4, 1e-4)
    close_scaled(img, want_img.numpy(), 1e-3, 2e-4)
    three = make_mesh(3, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        make_reenact_fn(g, a, deca, spec, mesh=three, **kw)(*args)
    with pytest.raises(ValueError, match="must divide"):
        make_fused_reenact_fn(g, a, deca, spec, ps, pf, fan_params=pf, s3fd_params=ps,
                              mesh=three, device="cpu")(
            world["code"], world["ps"], world["ang"], np.zeros((2, 64, 64, 3), np.uint8))