"""The port's whole serving slice against the JAX package's on the CPU,
plus the port's guards.

``reenact_batch`` with the resize alignment, T = 2 target frames: a
random-init 64² generator (channel multiplier 1), the full DECA ResNet-50
at 224 and A (15 → 8·512). The JAX pytrees come from seeded weights through
the JAX package's own checkpoint converters (quicker than its eager init)
and go into the port with ``weights/from_jax.py``. Inputs are made with
numpy from a seed.

Tolerances: target coefficients rtol 1e-3, atol 1e-3·max|coefficient|
(the DECA encoder bound); latents rtol 1e-4, atol 1e-4·max|latent| (the
coefficients' last digits pass through Δp and A); images rtol 1e-3,
atol 2e-4·max|image| (the generator bound, scaled to this random-init
generator's image range).
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.geometry.directions import (
    initialize_directions as j_initialize_directions)
from stylegan_directions_face_reenactment_tpu.models.deca.deca import (
    calculate_shapemodel as j_calculate_shapemodel)
from stylegan_directions_face_reenactment_tpu.models.direction_matrix import (
    init_direction_matrix)
from stylegan_directions_face_reenactment_tpu.models.stylegan2 import (
    mapping as j_mapping, n_latent_for)
from stylegan_directions_face_reenactment_tpu.pipeline.reenactment import (
    reenact_batch as j_reenact_batch)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_resnet_encoder, convert_stylegan2_generator)

import stylegan_directions_face_reenactment_tpu_torch as port_pkg
from stylegan_directions_face_reenactment_tpu_torch.geometry import (
    initialize_directions)
from stylegan_directions_face_reenactment_tpu_torch.models.deca.deca import (
    calculate_shapemodel)
from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
    make_reenact_fn, reenact_batch)
from stylegan_directions_face_reenactment_tpu_torch.weights import (
    deca_from_jax, direction_matrix_from_jax, generator_from_jax, init_deca,
    init_generator)

SIZE = 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(port_pkg.__file__)))


def to_np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


@pytest.fixture(scope="module")
def world():
    sd = {k: (v[None] if k.endswith("conv.weight") else v) for k, v in
          init_generator(1, size=SIZE, channel_multiplier=1, device="cpu")
          .state_dict().items()}
    g = to_np(convert_stylegan2_generator(sd, size=SIZE, channel_multiplier=1))
    rs = np.random.RandomState(0)
    for c in [g["conv1"]] + g["convs"]:
        c["noise_weight"] = np.float32(rs.randn() * 0.5)
    deca = {"e_flame": to_np(convert_resnet_encoder(
        init_deca(2, device="cpu").E_flame.state_dict()))}
    a = to_np(init_direction_matrix(jax.random.PRNGKey(3), 512, 15, w_plus=True,
                                    num_layers=8))
    z = rs.randn(32, 512).astype(np.float32)
    trunc = np.asarray(j_mapping(g, jnp.asarray(z)).mean(axis=0, keepdims=True))
    code = rs.randn(1, n_latent_for(SIZE), 512).astype(np.float32)
    src = rs.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    ps, ang = jax.jit(lambda im: j_calculate_shapemodel(deca, im))(src)
    tgts = rs.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    port = (generator_from_jax(g, device="cpu"),
            direction_matrix_from_jax(a, device="cpu"),
            deca_from_jax(deca, device="cpu"))
    return dict(jax=(g, a, deca), port=port, trunc=trunc, code=code,
                ps={k: np.asarray(v) for k, v in ps.items()},
                ang=np.asarray(ang), tgts=tgts)


def _close_scaled(got, want, rtol, atol_rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


def _jax_reenact(world, compute_dtype):
    g, a, deca = world["jax"]
    spec_j = j_initialize_directions("voxceleb", 15, 6.0)
    return jax.jit(
        lambda code, ps, ang, tg: j_reenact_batch(
            g, a, deca, spec_j, code, ps, ang, tg, truncation=0.7,
            truncation_latent=jnp.asarray(world["trunc"]),
            compute_dtype=compute_dtype, return_target_params=True))(
        world["code"], world["ps"], world["ang"], world["tgts"])


def _port_reenact(world, compute_dtype):
    pg, pa, pdeca = world["port"]
    t = torch.tensor
    with torch.no_grad():
        return reenact_batch(
            pg, pa, pdeca, initialize_directions("voxceleb", 15, 6.0),
            t(world["code"]), {k: t(v) for k, v in world["ps"].items()},
            t(world["ang"]), t(world["tgts"]), truncation=0.7,
            truncation_latent=t(world["trunc"]), compute_dtype=compute_dtype,
            return_target_params=True)


@pytest.fixture(scope="module")
def jax_f32(world):
    return _jax_reenact(world, jnp.float32)


def _mean_rel(got, want):
    """mean |got - want| / mean |want|, in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def test_reenact_batch_matches_jax(world, jax_f32):
    want_img, want_lat, want_pt, want_at = jax_f32
    img, lat, pt, at = _port_reenact(world, torch.float32)
    assert img.shape == (2, SIZE, SIZE, 3) and lat.shape == (2, n_latent_for(SIZE), 512)
    for k in want_pt:
        _close_scaled(pt[k].numpy(), want_pt[k], 1e-3, 1e-3)
    np.testing.assert_allclose(at.numpy(), np.asarray(want_at), rtol=0, atol=1e-2)
    _close_scaled(lat.numpy(), want_lat, 1e-4, 1e-4)
    _close_scaled(img.numpy(), want_img, 1e-3, 2e-4)


def test_reenact_batch_bf16_matches_jax(world, jax_f32):
    """``compute_dtype=bfloat16`` against the JAX package's bf16 slice.

    Both run the DECA trunk in bf16; the JAX synthesis promotes to f32 at
    its first noise add, the port's stays in bf16, and the two round in
    other places, so the limits are about twice the mean relative drift
    read here: coefficients 0.0026-0.0044 (limit 0.009), angles 0.0057
    (0.012), latents 0.011 (0.022), images 0.028 (0.055). Against the f32
    slice, the port's bf16 image must be no further off than the JAX
    package's own bf16 image (ratio read 0.82; limit 1.25). This file keeps
    every core (it takes no ``_threads``): the angles read 0.0129 at one
    thread, where ``F.interpolate``'s thread-dependent last bits reach the
    bf16 trunk (the three tests below).
    """
    want_img, want_lat, want_pt, want_at = _jax_reenact(world, jnp.bfloat16)
    img, lat, pt, at = _port_reenact(world, torch.bfloat16)
    assert img.dtype == torch.float32 and torch.isfinite(img).all()
    for k in want_pt:
        assert _mean_rel(pt[k], want_pt[k]) < 0.009, k
    assert _mean_rel(at, want_at) < 0.012
    assert _mean_rel(lat, want_lat) < 0.022
    assert _mean_rel(img, want_img) < 0.055
    f32_img = jax_f32[0]
    ratio = _mean_rel(img, f32_img) / _mean_rel(want_img, f32_img)
    assert ratio < 1.25, ratio


def _at_threads(fn):
    """fn() with torch on one thread, then on every core; the caller's
    thread count is restored after."""
    before = torch.get_num_threads()
    try:
        outs = []
        for n in (1, os.cpu_count() or 1):
            torch.set_num_threads(n)
            outs.append(fn())
        return outs
    finally:
        torch.set_num_threads(before)


def test_deca_trunk_bf16_ignores_the_thread_count(world):
    """The port's bf16 DECA trunk (ResNet-50 and its head, every conv and
    linear in bf16) gives bit-equal outputs at one thread and on every core
    for one fixed bf16 input: no reduction in the port's bf16 arithmetic
    depends on the thread count."""
    from stylegan_directions_face_reenactment_tpu_torch.models.deca.deca import (
        resnet_encoder_forward)
    e_flame = world["port"][2].E_flame
    x = torch.from_numpy(np.random.RandomState(7).uniform(
        0, 1, (2, 3, 224, 224)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        one, many = _at_threads(lambda: resnet_encoder_forward(e_flame, x))
    assert one.dtype == torch.bfloat16 and torch.isfinite(one.float()).all()
    assert torch.equal(one, many)


def test_resize_to_224_is_where_the_thread_count_enters(world):
    """``calculate_shapemodel`` resizes the f32 targets to 224 with
    ``models/nn.py::resize_bilinear`` (``F.interpolate``) before the bf16
    cast, and torch's CPU kernel sums in another order at another thread
    count. Read here (8 cores), one thread against eight: 115,523 of the
    301,056 f32 outputs differ, 3,230 of them by more than 1 ulp, at most
    by 3 ulp; after the cast 4 of the 301,056 bf16 trunk inputs differ.
    Limits: 4 ulp in f32, at most 1e-4 of the values after the cast."""
    from stylegan_directions_face_reenactment_tpu_torch.models.nn import resize_bilinear
    x = ((torch.from_numpy(world["tgts"]).clamp(-1, 1) + 1.0) / 2.00001).permute(0, 3, 1, 2)
    one, many = _at_threads(lambda: resize_bilinear(x, (224, 224)))
    assert one.shape == (2, 3, 224, 224)
    a, b = one.numpy(), many.numpy()
    ulps = np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))
    flips = (one.to(torch.bfloat16) != many.to(torch.bfloat16)).sum().item()
    assert ulps.max() <= 4
    assert flips <= 1e-4 * one.numel(), flips


def test_deca_bf16_no_further_from_f32_than_jax(world):
    """At one thread and on every core, each of the port's bf16 DECA
    outputs (pose, alpha_shp, alpha_exp, cam and the angles, each on its
    own) is no further from the JAX package's f32 ones than the JAX
    package's own bf16 ones are: mean relative drift over 64 uniform 64²
    targets from numpy seed 0 (the world's DECA), ratio at most 1.25, a
    bound the thread count does not enter.

    Read here, one thread / eight: pose 1.101 / 1.064, alpha_shp 1.051 /
    1.054, alpha_exp 1.084 / 1.103, cam 1.014 / 1.031, angles 1.046 / 1.052.
    Fewer frames make the ratio of two small means noisy: on 16 frames the
    groups read 1.01-1.28 (angles 1.28), on a pair of frames 0.33-3.38
    (``tests/torch_bf16_drift.py``). XLA keeps excess precision between
    fused bf16 operations; with ``XLA_FLAGS=--xla_allow_excess_precision=false``,
    rounding after every operation as the eager port does, 16 frames read
    1.00-1.11.
    """
    deca, pdeca = world["jax"][2], world["port"][2]
    targets = np.random.RandomState(0).uniform(-1, 1, (64, SIZE, SIZE, 3)).astype(np.float32)

    def jax_run(dtype):
        pt, at = jax.jit(lambda im: j_calculate_shapemodel(deca, im, compute_dtype=dtype))(
            targets)
        return dict({k: np.asarray(v) for k, v in pt.items()}, angles=np.asarray(at))

    def port_run():
        with torch.no_grad():
            pt, at = calculate_shapemodel(pdeca, torch.from_numpy(targets),
                                          compute_dtype=torch.bfloat16)
        return dict({k: v.numpy() for k, v in pt.items()}, angles=at.numpy())

    f32, bf16 = jax_run(None), jax_run(jnp.bfloat16)
    assert sorted(f32) == ["alpha_exp", "alpha_shp", "angles", "cam", "pose"]
    for got in _at_threads(port_run):
        ratios = {k: _mean_rel(got[k], f32[k]) / _mean_rel(bf16[k], f32[k]) for k in f32}
        assert max(ratios.values()) <= 1.25, ratios


def test_make_reenact_fn_on_cpu(world):
    """The entry point: numpy in, tensors out, the same as reenact_batch;
    the bf16 path stays near the f32 one (mean relative drift read 0.050;
    limit 0.1)."""
    pg, pa, pdeca = world["port"]
    spec = initialize_directions("voxceleb", 15, 6.0)
    trunc = torch.from_numpy(world["trunc"])
    args = (world["code"], world["ps"], world["ang"], world["tgts"])
    fn = make_reenact_fn(pg, pa, pdeca, spec, truncation_latent=trunc, device="cpu")
    img, lat = fn(*args)
    with torch.no_grad():
        want, _ = reenact_batch(
            pg, pa, pdeca, spec, torch.from_numpy(world["code"]),
            {k: torch.from_numpy(v) for k, v in world["ps"].items()},
            torch.from_numpy(world["ang"]), torch.from_numpy(world["tgts"]),
            truncation_latent=trunc)
    torch.testing.assert_close(img, want, rtol=0, atol=0)
    assert lat.shape == (2, n_latent_for(SIZE), 512)
    fn16 = make_reenact_fn(pg, pa, pdeca, spec, truncation_latent=trunc,
                           compute_dtype=torch.bfloat16, device="cpu")
    img16, _ = fn16(*args)
    assert img16.dtype == torch.float32 and torch.isfinite(img16).all()
    assert float((img16 - img).abs().mean() / img.abs().mean()) < 0.1


def test_entry_point_needs_a_card_unless_cpu_is_asked(world, monkeypatch):
    pg, pa, pdeca = world["port"]
    spec = initialize_directions("voxceleb", 15, 6.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_reenact_fn(pg, pa, pdeca, spec)


def test_mesh_over_two_cpu_slots_matches_jax(world, jax_f32):
    """``mesh=``: frame data parallelism over a two-slot CPU mesh, a frame
    a slot, gathered in order; against the JAX package's slice at this
    file's limits, and against the one-device entry point (the same
    limits: a batch of one and of two may sum in other orders)."""
    from stylegan_directions_face_reenactment_tpu_torch.parallel import make_mesh
    pg, pa, pdeca = world["port"]
    spec = initialize_directions("voxceleb", 15, 6.0)
    kw = dict(truncation_latent=torch.from_numpy(world["trunc"]), return_target_params=True,
              device="cpu")
    args = (world["code"], world["ps"], world["ang"], world["tgts"])
    img, lat, pt, at = make_reenact_fn(pg, pa, pdeca, spec, mesh=make_mesh(2, device="cpu"),
                                       **kw)(*args)
    one = make_reenact_fn(pg, pa, pdeca, spec, **kw)(*args)
    for want_img, want_lat, want_pt, want_at in (jax_f32, [np.asarray(x) if not isinstance(
            x, dict) else {k: v.numpy() for k, v in x.items()} for x in one]):
        for k in want_pt:
            _close_scaled(pt[k].numpy(), want_pt[k], 1e-3, 1e-3)
        np.testing.assert_allclose(at.numpy(), np.asarray(want_at), rtol=0, atol=1e-2)
        _close_scaled(lat.numpy(), want_lat, 1e-4, 1e-4)
        _close_scaled(img.numpy(), want_img, 1e-3, 2e-4)


def test_port_imports_no_jax():
    """Importing every module of the port leaves JAX and the JAX package
    out of sys.modules (a fresh interpreter, so this file's imports do not
    count)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import stylegan_directions_face_reenactment_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == "
        "'stylegan_directions_face_reenactment_tpu' or "
        "m.startswith('stylegan_directions_face_reenactment_tpu.')]\n"
        "assert len(names) > 15, names\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
