"""The port's training steps (``train/steps.py``) against the JAX package's
builders on the CPU, each JAX builder built once in this module.

World: ``tests/torch_train_world.py`` (64² generator, DECA with a small
synthetic FLAME, damped ArcFace, LPIPS, a 2-module FAN). Batch 2. Each
port step runs ``grads_only`` on the JAX step's own draws (``split(rng, 3)``
→ normal / normal / (randint, uniform), as the JAX step makes them), and
the cached steps take coefficients from the port's ``make_shape_program``,
fed to both. The ID term is out (``lambda_identity`` = 0): the random
ArcFace's gradient is chaotic, and the ID term's values are held in
``test_torch_train_losses.py`` and ``test_torch_id_loss.py``.

Tolerances: the loss terms rtol 1e-4; A's gradient rtol 1e-3, atol
1e-3·max|gradient|, and the port's own gradient under a 1e-6 change of A
within the same (every compared step); Adam's update rtol 1e-5, atol 1e-7
(lr 1e-4); the accumulated step against the monolithic one rtol 1e-5 on
the terms and the gradient as against JAX (the convolutions of a batch of
one and of two sum in other orders: read 5e-4 relative).
"""

import copy
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.configs.arguments import (
    TrainingArguments as JArgs)
from stylegan_directions_face_reenactment_tpu.geometry import initialize_directions as j_init_dirs
from stylegan_directions_face_reenactment_tpu.train import steps as jsteps

from stylegan_directions_face_reenactment_tpu_torch.configs import TrainingArguments
from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
from stylegan_directions_face_reenactment_tpu_torch.train import steps as psteps
from stylegan_directions_face_reenactment_tpu_torch.train.steps import Draws
from stylegan_directions_face_reenactment_tpu_torch.weights import init_direction_matrix

from torch_threads import _threads  # noqa: F401
from torch_train_world import DECA_SIZE, N_LAT, SIZE, build_train_world, close_scaled, t

B = 2
SPEC, JSPEC = initialize_directions(), j_init_dirs("voxceleb", 15, 6.0)
COMMON = dict(batch_size=B, image_resolution=SIZE, lambda_identity=0.0, lambda_w_reg=0.5,
              deca_image_size=DECA_SIZE)



@pytest.fixture(scope="module")
def world():
    w = build_train_world()
    a = init_direction_matrix(8, device="cpu")
    w["a"] = a
    w["a_jax"] = {"weight": a.linear.weight.detach().numpy().copy(),
                  "bias": a.linear.bias.detach().numpy().copy(),
                  "meta": {"shift_dim": 512, "input_dim": 15, "w_plus": True,
                           "num_layers": 8}}
    rs = np.random.RandomState(11)
    w["inputs"] = {"src_w": (0.5 * rs.randn(B, N_LAT, 512)).astype(np.float32),
                   "tgt_w": (0.5 * rs.randn(B, N_LAT, 512)).astype(np.float32),
                   "src_img": rs.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
                   "tgt_img": rs.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)}
    return w


def args_pair(**kw):
    return TrainingArguments(**COMMON, **kw), JArgs(**COMMON, **kw)


def jax_draws(rng, *, source):
    """The JAX steps' draws: synthetic (k_src, k_tgt, k_dir), real
    (k_tgt, k_dir, k_syn)."""
    keys = jax.random.split(rng, 3)
    k_dir = keys[2] if source else keys[1]
    k_ind, k_shift = jax.random.split(k_dir)
    d = Draws(z_tgt=t(jax.random.normal(keys[1] if source else keys[0], (B, 512))),
              target_indices=t(jax.random.randint(k_ind, (B // 2,), 0, 15)),
              u=t(jax.random.uniform(k_shift, (B // 2,))))
    if source:
        d = d._replace(z_src=t(jax.random.normal(keys[0], (B, 512))))
    return d


def shapes(world, args, *imgs):
    fn = psteps.make_shape_program(world["port"], args)
    out = []
    for img in imgs:
        p, ang = fn(t(img))
        out += [{k: v.numpy() for k, v in p.items()}, ang.numpy()]
    return out


def tree_t(xs):
    return [({k: t(v) for k, v in x.items()} if isinstance(x, dict) else t(x)) for x in xs]


def check_step(world, jbuilder, pbuilder, args, jargs, extra, draws=None, rng=None, **kw):
    """The port's step against the JAX builder's, after a witness that the
    port's gradient does not jump under a 1e-6 relative change of A: the L1
    shape losses have kinks, and a gradient taken beside one moves further
    than any comparison of two float32 programs could pass."""
    pstep = pbuilder(world["port"], SPEC, args, grads_only=True, **kw)
    p_extra, draws = tree_t(extra), draws or Draws()
    got, got_g = pstep(world["a"], None, *p_extra, draws=draws)
    moved = copy.deepcopy(world["a"])
    with torch.no_grad():
        moved.linear.weight.mul_(1 + 1e-6)
    close_scaled(pstep(moved, None, *p_extra, draws=draws)[1]["weight"],
                 got_g["weight"].numpy(), 1e-3, 1e-3)
    jstep = jbuilder(world["jax"], JSPEC, jargs, jsteps.make_optimizer(jargs), grads_only=True,
                     **kw)
    want, want_g = jstep(world["a_jax"], rng if rng is not None else jax.random.PRNGKey(0),
                         *extra)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    for k in ("weight", "bias"):
        close_scaled(got_g[k], want_g[k], 1e-3, 1e-3)
    return got_g


def test_synthetic_step_matches_jax(world):
    """fan_frame alignment: FAN on the frame, the kpt68 warp, DECA. The
    shifted image lies close to the source, so the L1 shape losses sit near
    their kinks (with the resize alignment at this seed the witness of
    ``check_step`` fails: the port's own gradient moves 5e-3 of its max)."""
    args, jargs = args_pair(deca_alignment="fan_frame")
    rng = jax.random.PRNGKey(3)
    draws = jax_draws(rng, source=True)
    world["grads"] = check_step(world, jsteps.make_synthetic_step, psteps.make_synthetic_step,
                                args, jargs, (), draws=draws, rng=rng)


def test_real_step_cached_shape_matches_jax(world):
    args, jargs = args_pair(deca_alignment="resize", training_method="real")
    i = world["inputs"]
    p, ang = shapes(world, args, i["src_img"])
    rng = jax.random.PRNGKey(4)
    check_step(world, jsteps.make_real_step, psteps.make_real_step, args, jargs,
               (i["src_w"], i["src_img"], p, ang), draws=jax_draws(rng, source=False),
               rng=rng, cached_shape=True)


@pytest.mark.parametrize("cached", [True, False])
def test_paired_step_matches_jax(world, cached):
    """Coefficients from the Trainer's cache, or recomputed in the step."""
    args, jargs = args_pair(deca_alignment="resize", training_method="paired")
    i = world["inputs"]
    if cached:
        extra = (i["src_w"], i["tgt_w"], i["tgt_img"],
                 *shapes(world, args, i["src_img"], i["tgt_img"]))
    else:
        extra = (i["src_w"], i["src_img"], i["tgt_w"], i["tgt_img"])
    check_step(world, jsteps.make_paired_step, psteps.make_paired_step, args, jargs, extra,
               cached_shape=cached)


def test_remat_step_matches_the_plain_one(world):
    """``remat`` recomputes the shifted synthesis and the shape and loss
    block in the backward (``torch.utils.checkpoint``): the same terms and
    gradients, bit for bit on the CPU."""
    i = world["inputs"]
    extra = tree_t((i["src_w"], i["src_img"], i["tgt_w"], i["tgt_img"]))
    out = []
    for remat in (False, True):
        args, _ = args_pair(deca_alignment="resize", training_method="paired", remat=remat)
        out.append(psteps.make_paired_step(world["port"], SPEC, args, grads_only=True)(
            world["a"], None, *extra))
    (t0, g0), (t1, g1) = out
    assert all(torch.equal(t0[k], t1[k]) for k in t0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_adam_update_matches_jax_optimizer(world):
    """Two ``torch.optim.Adam`` updates (lr, weight decay 5e-4 added to the
    gradient) against JAX ``make_optimizer``'s on the same gradients."""
    grads = world.get("grads") or {"weight": torch.randn(4096, 15), "bias": torch.randn(4096)}
    args, jargs = args_pair()
    a = init_direction_matrix(8, device="cpu")
    opt = psteps.make_optimizer(a, args)
    params = {"weight": a.linear.weight.detach().numpy().copy(),
              "bias": a.linear.bias.detach().numpy().copy()}
    tx = jsteps.make_optimizer(jargs)
    state = tx.init(params)
    for scale in (1.0, -0.5):
        g = {k: (scale * v).numpy() for k, v in grads.items()}
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        a.linear.weight.grad, a.linear.bias.grad = t(g["weight"]), t(g["bias"])
        opt.step()
    np.testing.assert_allclose(a.linear.weight.detach().numpy(), params["weight"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(a.linear.bias.detach().numpy(), params["bias"], rtol=1e-5,
                               atol=1e-7)


def test_accumulated_paired_step_matches_monolithic(world):
    """Two microbatches of one pair each, averaged into one Adam update,
    against the batch of two: the same terms and the same gradient (the
    paired step draws nothing)."""
    args, _ = args_pair(deca_alignment="resize", training_method="paired")
    i = world["inputs"]
    extra = tree_t((i["src_w"], i["src_img"], i["tgt_w"], i["tgt_img"]))
    runs = []
    for n_micro in (1, 2):
        a = init_direction_matrix(8, device="cpu")
        opt = psteps.make_optimizer(a, args)
        step = psteps.make_accum_step(psteps.make_paired_step, world["port"], SPEC, args, opt,
                                      n_micro=n_micro)
        runs.append((step(a, None, *extra), a.linear.weight.grad.clone(), a))
    (mono, g_mono, a_mono), (acc, g_acc, a_acc) = runs
    assert set(acc) == set(mono)
    for k in mono:
        rtol = 1e-3 if k == "grad_norm" else 1e-5     # a gradient, not a loss term
        np.testing.assert_allclose(float(acc[k]), float(mono[k]), rtol=rtol, err_msg=k)
    close_scaled(g_acc, g_mono.numpy(), 1e-3, 1e-3)
    assert not torch.equal(a_acc.linear.weight, init_direction_matrix(8, device="cpu")
                           .linear.weight)


def test_accum_step_checks_its_microbatches_when_built(world):
    """The sizes are refused when the step is built: a real_synthetic batch
    whose real half does not split into the microbatches' halves (12 / 4 =
    3 a microbatch, a half of 1.5), an odd disentanglement-50 microbatch,
    and a batch the count does not divide."""
    opt = psteps.make_optimizer(init_direction_matrix(8, device="cpu"), args_pair()[0])
    m = world["port"]

    def build(builder, n, **kw):
        args = dataclasses.replace(args_pair()[0], batch_size=12)
        return psteps.make_accum_step(builder, m, SPEC, args, opt, n_micro=n, **kw)

    with pytest.raises(ValueError, match="real half"):
        build(psteps.make_real_step, 4, synthetic_half=True)
    with pytest.raises(ValueError, match="even"):
        build(psteps.make_synthetic_step, 4)
    with pytest.raises(ValueError, match="divide"):
        build(psteps.make_paired_step, 5)
    build(psteps.make_real_step, 3, synthetic_half=True)     # 12 / 3 = 4: halves of 2
    build(psteps.make_paired_step, 4)                        # paired draws nothing


def test_sample_draws_are_the_generators():
    """One seed, one set of draws; the sampler's shapes per method."""
    args = TrainingArguments(batch_size=4)
    d1, d2 = (psteps.sample_draws(torch.Generator().manual_seed(2), args, SPEC, "cpu",
                                  source=True, target=True, syn=2) for _ in range(2))
    for x, y in zip(d1, d2):
        assert torch.equal(x, y)
    assert d1.z_src.shape == (4, 512) and d1.z_syn.shape == (2, 512)
    assert d1.target_indices.shape == (2,) and float(d1.u.max()) < 1.0
