"""The port's training losses (``losses/shape_losses.py``,
``geometry/directions.py``'s disentanglement-50 functions,
``train/losses_stack.py``) against the JAX package on the CPU.

Nets: ``tests/torch_train_world.py`` (the small synthetic FLAME through
``flame_from_jax``, the damped ArcFace backbone, LPIPS). Inputs are made
with numpy from a seed: coefficients of the DECA layout, angles in degrees,
landmarks, and 256² images in [-1, 1]. The disentanglement-50 draws cover
every one of the 15 directions.

Tolerances: the loss terms rtol 1e-4 (float32); Δp and the ground-truth
coefficients rtol 1e-5, atol 1e-5·max; the gradients of the loss stack
with ``lambda_identity`` = 0 rtol 1e-3, atol 1e-3·max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.geometry import directions as jdir
from stylegan_directions_face_reenactment_tpu.losses import shape_losses as jsl
from stylegan_directions_face_reenactment_tpu.train import losses_stack as jls
from stylegan_directions_face_reenactment_tpu.utils.image_utils import (
    torch_range_1_to_255 as j_range)

from stylegan_directions_face_reenactment_tpu_torch.geometry import directions as pdir
from stylegan_directions_face_reenactment_tpu_torch.losses import shape_losses as psl
from stylegan_directions_face_reenactment_tpu_torch.train import losses_stack as pls
from stylegan_directions_face_reenactment_tpu_torch.utils.image_utils import torch_range_1_to_255

from torch_face_zoo import statics_jit
from torch_threads import _threads  # noqa: F401
from torch_train_world import build_train_world, close_scaled, t

B = 30                       # the second half picks each of the 15 directions once
LOSS_RTOL = 1e-4
SPEC = pdir.initialize_directions("voxceleb", 15, 6.0)
JSPEC = jdir.initialize_directions("voxceleb", 15, 6.0)



@pytest.fixture(scope="module")
def world():
    return build_train_world()


def coeffs(rs, n):
    return {"pose": (0.2 * rs.randn(n, 6)).astype(np.float32),
            "alpha_shp": rs.randn(n, 100).astype(np.float32),
            "alpha_exp": rs.randn(n, 50).astype(np.float32),
            "cam": (np.abs(rs.randn(n, 3)) + 1).astype(np.float32)}


@pytest.fixture(scope="module")
def draws():
    rs = np.random.RandomState(0)
    return {"src": coeffs(rs, B), "tgt": coeffs(rs, B), "shifted": coeffs(rs, B),
            "ang_src": (15 * rs.randn(B, 3)).astype(np.float32),
            "ang_tgt": (15 * rs.randn(B, 3)).astype(np.float32),
            "idx": rs.permutation(15).astype(np.int32),
            "u": rs.rand(B // 2).astype(np.float32)}


def tt(d):
    return {k: t(v) for k, v in d.items()}


@pytest.mark.parametrize("name", ["shape_loss", "eye_loss", "mouth_loss", "pixel_wise_loss",
                                  "l2_loss"])
def test_shape_and_pixel_losses_match_jax(name):
    rs = np.random.RandomState(1)
    shape = (4, 68, 2) if name in ("eye_loss", "mouth_loss") else (4, 128, 3)
    a, b = (rs.randn(*shape).astype(np.float32) * 50 for _ in range(2))
    want = float(getattr(jsl, name)(a, b))
    got = float(getattr(psl, name)(t(a), t(b)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_range_1_to_255_matches_jax():
    x = np.random.RandomState(2).uniform(-1.2, 1.2, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(torch_range_1_to_255(t(x)).numpy(), np.asarray(j_range(x)))


def test_shift_vector_50_and_gt_params_match_jax(draws):
    d = draws
    want_sv = np.asarray(jdir.make_shift_vector_50_from(
        JSPEC, d["src"], d["tgt"], d["ang_src"], d["ang_tgt"], d["idx"], d["u"]))
    got_sv = pdir.make_shift_vector_50_from(SPEC, tt(d["src"]), tt(d["tgt"]), t(d["ang_src"]),
                                            t(d["ang_tgt"]), t(d["idx"]), t(d["u"]))
    close_scaled(got_sv, want_sv, 1e-5, 1e-5)
    want = jdir.get_params_gt_reenacted(*jax.tree_util.tree_map(
        jnp.asarray, (JSPEC, d["src"], d["tgt"], want_sv, d["idx"], d["ang_src"])))
    got = pdir.get_params_gt_reenacted(SPEC, tt(d["src"]), tt(d["tgt"]), got_sv,
                                       t(d["idx"]), t(d["ang_src"]))
    for k in ("pose", "exp"):
        close_scaled(got[k], want[k], 1e-5, 1e-5)
    # each second-half sample moved exactly its one direction's attribute
    moved = np.abs(got["pose"].numpy()[B // 2:] - d["src"]["pose"][B // 2:]).sum(1) + np.abs(
        got["exp"].numpy()[B // 2:] - d["src"]["alpha_exp"][B // 2:]).sum(1)
    assert (moved > 0).all()


def test_shift_vector_50_draws_from_the_generator():
    """``make_shift_vector_50`` draws its indices in [0, k) and positions in
    [0, 1) from the generator: the same seed gives the same batch."""
    rs = np.random.RandomState(3)
    src, tgt = tt(coeffs(rs, 8)), tt(coeffs(rs, 8))
    ang = t((10 * rs.randn(8, 3)).astype(np.float32))
    runs = [pdir.make_shift_vector_50(SPEC, src, tgt, ang, ang, torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert runs[0][1].shape == (4,) and int(runs[0][1].max()) < 15
    with pytest.raises(ValueError):
        pdir.make_shift_vector_50(SPEC, src, tgt, ang[:3], ang[:3], torch.Generator())


LAMBDAS = {"lambda_identity": 10.0, "lambda_perceptual": 10.0, "lambda_pixel_wise": 1.0,
           "lambda_shape": 1.0, "lambda_mouth_shape": 1.0, "lambda_eye_shape": 1.0,
           "lambda_w_reg": 0.5}
NB = 4


def _inputs(draws):
    rs = np.random.RandomState(4)
    sl = slice(B // 2 - NB // 2, B // 2 + NB // 2)     # 2 full-Δp, 2 single-direction
    d = {k: ({n: v[sl] for n, v in draws[k].items()}) for k in ("src", "tgt", "shifted")}
    ang = draws["ang_src"][sl]
    idx = draws["idx"][:NB // 2]
    sv = np.asarray(jdir.make_shift_vector_50_from(JSPEC, d["src"], d["tgt"], ang,
                                                   draws["ang_tgt"][sl], idx,
                                                   draws["u"][:NB // 2]))
    imgs = [rs.uniform(-1, 1, (NB, 256, 256, 3)).astype(np.float32) for _ in range(2)]
    lat = [rs.randn(NB, 14, 512).astype(np.float32) for _ in range(2)]
    return d, ang, idx, sv, imgs, lat


def _port_nets(world):
    m = world["port"]
    return m.deca, m.id_backbone, m.lpips


def _jax_nets(world):
    m = world["jax"]
    return m.deca, m.id_backbone, m.lpips


def _jax_run(world, jfn, lambda_identity, *xs):
    """The JAX stack's terms, and with the ID term out its gradients with
    respect to ``xs`` (the random ArcFace's gradient is not held)."""
    if lambda_identity:
        return statics_jit(lambda *a: jfn(*a)[1], *_jax_nets(world))(*xs), None
    (_, terms), grads = statics_jit(lambda deca, idb, lp, *ys: jax.value_and_grad(
        lambda *zs: jfn(deca, idb, lp, *zs), argnums=(0, 1, 2), has_aux=True)(*ys),
        *_jax_nets(world))(*xs)
    return terms, grads


@pytest.mark.parametrize("lambda_identity", [10.0, 0.0])
def test_calculate_losses_matches_jax(world, draws, lambda_identity):
    """The unpaired stack: every term with the ID term in; with it out, the
    gradients to the shifted coefficients and the shifted image too."""
    d, ang, idx, sv, (src_img, sh_img), _ = _inputs(draws)
    lam = {**LAMBDAS, "lambda_identity": lambda_identity}

    def jfn(deca, idb, lp, p_sh_pose, p_sh_exp, img):
        jd, jang, jsv, jidx, jsrc = jax.tree_util.tree_map(jnp.asarray,
                                                           (d, ang, sv, idx, src_img))
        p_sh = {**jd["shifted"], "pose": p_sh_pose, "alpha_exp": p_sh_exp}
        return jls.calculate_losses(deca, idb, lp, JSPEC, lam, jd["src"], jang, p_sh,
                                    jd["tgt"], jsv, jidx, jsrc, img)

    want, want_grads = _jax_run(world, jfn, lambda_identity,
                                d["shifted"]["pose"], d["shifted"]["alpha_exp"], sh_img)
    leaves = [t(d["shifted"]["pose"]).requires_grad_(), t(d["shifted"]["alpha_exp"])
              .requires_grad_(), t(sh_img).requires_grad_()]
    p_sh = {**tt(d["shifted"]), "pose": leaves[0], "alpha_exp": leaves[1]}
    total, got = pls.calculate_losses(*_port_nets(world), SPEC, lam, tt(d["src"]), t(ang), p_sh,
                                      tt(d["tgt"]), t(sv), t(idx), t(src_img), leaves[2])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    if lambda_identity == 0:
        for g, w in zip(torch.autograd.grad(total, leaves), want_grads):
            close_scaled(g, w, 1e-3, 1e-3)


@pytest.mark.parametrize("lambda_identity", [10.0, 0.0])
def test_calculate_losses_paired_matches_jax(world, draws, lambda_identity):
    """The paired stack with LPIPS and the pixel loss on [0, 255] and the W+
    regulariser."""
    d, _, _, _, (tgt_img, sh_img), (sh_lat, tgt_w) = _inputs(draws)
    lam = {**LAMBDAS, "lambda_identity": lambda_identity}

    def jfn(deca, idb, lp, p_sh_pose, img, lat):
        p_sh = {**d["shifted"], "pose": p_sh_pose}
        return jls.calculate_losses_paired(deca, idb, lp, lam, p_sh, d["tgt"], img, tgt_img,
                                           lat, tgt_w)

    want, want_grads = _jax_run(world, jfn, lambda_identity, d["shifted"]["pose"], sh_img,
                                sh_lat)
    leaves = [t(x).requires_grad_() for x in (d["shifted"]["pose"], sh_img, sh_lat)]
    p_sh = {**tt(d["shifted"]), "pose": leaves[0]}
    total, got = pls.calculate_losses_paired(*_port_nets(world), lam, p_sh, tt(d["tgt"]),
                                             leaves[1], t(tgt_img), leaves[2], t(tgt_w))
    assert set(got) == set(want) and "loss_w_reg" in got and "loss_pixel_wise" in got
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    if lambda_identity == 0:
        for g, w in zip(torch.autograd.grad(total, leaves), want_grads):
            close_scaled(g, w, 1e-3, 1e-3)
