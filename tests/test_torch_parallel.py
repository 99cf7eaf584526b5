"""The port's scaling layer (``parallel/mesh.py``) against the JAX package's
``parallel/mesh.py`` on the CPU, and data-parallel training over a gloo
world of 2 CPU processes.

The mesh helpers mirror ``tests/test_parallel.py``: a CPU mesh of ``n``
slots stands for the JAX tests' virtual CPU devices, and a rank's rows
(``shard_batch(..., rank, world)``) for a process's shard.

One world of 2 is spawned for the module (``tests/torch_parallel_world.py``
runs in each rank; it imports no JAX). Its cases on the world of
``tests/torch_train_world.py`` (resize alignment, the ID term out):

* the paired step at batch 2 (a row a rank; A's gradient averaged over the
  world before Adam; the frames' coefficients cached, fed to both sides as
  ``tests/test_torch_train_steps.py`` feeds them) against the JAX
  package's one-device step: loss terms
  rtol 1e-4, gradient rtol 1e-3 and atol 1e-3·max, after the witness of
  ``tests/test_torch_train_steps.py::check_step`` (the port's gradient
  under a 1e-6 change of A moves less than that);
* the synthetic step at batch 4 with disentanglement-50 (every rank draws
  the global batch from one generator seed and keeps its block of each
  half) against the port's one-process step on the same seed: the same
  limits, the same witness;
* grad_accum 2 (paired, batch 4, reduced once after the second
  microbatch) against the one-process batch-4 step: terms rtol 1e-5
  (grad_norm 1e-3), gradient as above;
* a Trainer run of 2 steps saving and evaluating every step: only rank 0
  writes, and the ranks end with the same A bit for bit; each rank's
  metrics of a sharded evaluation (batches of 2, a row a rank) and of a
  batch of 3 (whole on every rank) against the one-process ``evaluate`` on
  the same A: rtol 1e-4, atol 1e-6.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.configs.arguments import (
    TrainingArguments as JArgs)
from stylegan_directions_face_reenactment_tpu.geometry import initialize_directions as j_dirs
from stylegan_directions_face_reenactment_tpu.parallel import mesh as jmesh
from stylegan_directions_face_reenactment_tpu.train import steps as jsteps

from stylegan_directions_face_reenactment_tpu_torch.parallel import (
    DATA_AXIS, DCN_AXIS, data_parallel, distributed_init, launch, make_hybrid_mesh, make_mesh,
    pad_to_multiple, rank_rows, replicate, shard_batch, world_info)
from stylegan_directions_face_reenactment_tpu_torch.train import (
    make_optimizer, make_paired_step, make_shape_program, make_synthetic_step)
from stylegan_directions_face_reenactment_tpu_torch.weights import init_direction_matrix

import torch_parallel_world as pw
from torch_train_world import N_LAT, SIZE, build_train_world, close_scaled, t, torch_threads

N_DEV = 8

_threads = pytest.fixture(scope="module", autouse=True)(torch_threads)


def jax_devices(n):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} virtual devices, have {len(devs)}")
    return devs[:n]


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

def test_make_mesh_shape_matches_jax():
    m, jm = make_mesh(N_DEV, device="cpu"), jmesh.make_mesh(N_DEV, devices=jax_devices(N_DEV))
    assert m.shape == dict(jm.shape) == {DATA_AXIS: N_DEV}
    assert m.size == jm.size == N_DEV
    assert m.axis_names == tuple(jm.axis_names)
    # an explicit devices list is taken as given
    assert make_mesh(devices=["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2


def test_make_mesh_past_the_cards_raises(monkeypatch):
    """On the card the mesh is cuda:0..n-1, with JAX's error past the count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="only 1 device"):
        make_mesh(2)
    with pytest.raises(ValueError, match="only 1 device"):
        jmesh.make_mesh(2, devices=jax_devices(1))


def test_make_mesh_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)


def test_shard_batch_rows_match_jax_shards():
    """Rank r of 8 takes the rows of JAX's r-th shard; other leaves pass."""
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    jx = jmesh.shard_batch(jmesh.make_mesh(N_DEV, devices=jax_devices(N_DEV)), {"x": x})["x"]
    shards = sorted((sh.index[0].start, np.asarray(sh.data)) for sh in jx.addressable_shards)
    for r in range(N_DEV):
        part = shard_batch({"x": x, "meta": "keep-me"}, rank=r, world=N_DEV)
        assert part["meta"] == "keep-me" and part["x"].shape == (16 // N_DEV, 3)
        np.testing.assert_array_equal(part["x"], shards[r][1])
        got = shard_batch(torch.from_numpy(x), rank=r, world=N_DEV)
        np.testing.assert_array_equal(got.numpy(), shards[r][1])
    with pytest.raises(ValueError, match="must divide the process count"):
        rank_rows(10, 0, 4)


def test_rank_rows_of_groups():
    """With groups (halves, microbatches) a rank takes its block of each."""
    assert rank_rows(8, 1, 2, groups=2).tolist() == [2, 3, 6, 7]
    assert rank_rows(8, 0, 2, groups=4).tolist() == [0, 2, 4, 6]
    assert np.sort(np.concatenate([rank_rows(12, r, 3, groups=2) for r in range(3)])
                   ).tolist() == list(range(12))
    with pytest.raises(ValueError, match="groups"):
        rank_rows(8, 0, 4, groups=4)


def test_shard_batch_hybrid_all_axes():
    """A (dcn, dp) grid of 8 ranks shards over both axes: 8 disjoint 2-row
    blocks, as JAX's hybrid mesh."""
    devs = jax_devices(8)
    jm = jmesh.make_hybrid_mesh(8, dcn_slices=2, devices=devs)
    m = make_hybrid_mesh(8, dcn_slices=2, device="cpu")
    assert m.shape == dict(jm.shape) == {DCN_AXIS: 2, DATA_AXIS: 4}
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    starts = sorted(int(shard_batch(x, rank=r, world=m.size)[0, 0]) for r in range(m.size))
    jx = jmesh.shard_batch(jm, {"x": x})["x"]
    assert starts == sorted(int(sh.data[0, 0]) for sh in jx.addressable_shards)


def test_make_hybrid_mesh_shape_and_errors_match_jax():
    devs = jax_devices(8)
    for kw in ({"n_devices": 8, "dcn_slices": 2}, {"n_devices": 4}):
        m = make_hybrid_mesh(device="cpu", **kw)
        jm = jmesh.make_hybrid_mesh(devices=devs, **kw)
        assert m.shape == dict(jm.shape) and m.axis_names == tuple(jm.axis_names)
    for kw, match in (({"n_devices": 8, "dcn_slices": 3}, "must divide"),
                      ({"n_devices": 8, "dcn_slices": 0}, "dcn_slices")):
        with pytest.raises(ValueError, match=match):
            make_hybrid_mesh(device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            jmesh.make_hybrid_mesh(devices=devs, **kw)
    with pytest.raises(ValueError, match="available"):
        make_hybrid_mesh(16, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="available"):
        jmesh.make_hybrid_mesh(16, devices=devs)


def test_pad_to_multiple_matches_jax():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    for mult in (8, 5, 3):
        got, n = pad_to_multiple(x, mult)
        want, jn = jmesh.pad_to_multiple(x, mult)
        np.testing.assert_array_equal(got, want)
        assert n == jn
    padded, _ = pad_to_multiple(x, 8)
    same, n2 = pad_to_multiple(padded, 8)
    assert same is padded and n2 == 8


def test_distributed_init_noop_single_process(monkeypatch):
    """Nothing of torchrun's environment set: False, and no process group
    (the JAX package's no-op with its JAX_* variables unset)."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed_init() is False and jmesh.distributed_init() is False
    assert not torch.distributed.is_initialized() and world_info() == (0, 1)
    tree = {"w": torch.ones(3)}
    assert replicate(tree) is tree


def test_data_parallel_matches_data_parallel_jit():
    """A two-slot CPU mesh against ``data_parallel_jit`` on 2 virtual
    devices: rows in order (rtol 1e-6), modules and other arguments on
    every part, None batch arguments passed through."""
    rs = np.random.RandomState(0)
    x = rs.randn(16, 32).astype(np.float32)
    w = rs.randn(32, 8).astype(np.float32)
    want = jmesh.data_parallel_jit(lambda xb, wp: jnp.tanh(xb @ wp),
                                   jmesh.make_mesh(2, devices=jax_devices(2)))(
        jnp.asarray(x), jnp.asarray(w))
    lin = torch.nn.Linear(32, 8, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
    seen = []

    def fn(xb, none, layer, scale):
        seen.append((xb.shape[0], none))
        return {"y": torch.tanh(layer(xb)) * scale}

    got = data_parallel(fn, make_mesh(2, device="cpu"), batch_argnums=(0, 1),
                        replicated=[lin])(torch.from_numpy(x), None, lin, 1.0)["y"]
    assert seen == [(8, None), (8, None)]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="must divide"):
        data_parallel(fn, make_mesh(3, device="cpu"))(torch.from_numpy(x), None, lin, 1.0)


# ---------------------------------------------------------------------------
# a gloo world of 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = build_train_world()

    def frames(rs, b):
        return {"src_w": (0.5 * rs.randn(b, N_LAT, 512)).astype(np.float32),
                "tgt_w": (0.5 * rs.randn(b, N_LAT, 512)).astype(np.float32),
                "src_img": rs.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32),
                "tgt_img": rs.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)}

    # the paired batch of tests/test_torch_train_steps.py (its seed and
    # order), with its coefficients from the port's shape program
    w["inputs"] = {"paired": frames(np.random.RandomState(11), 2),
                   "accum": frames(np.random.RandomState(12), 4)}
    paired = w["inputs"]["paired"]
    shape = make_shape_program(w["port"], pw.case_args("paired"))
    for side in ("src", "tgt"):
        p, ang = shape(t(paired[f"{side}_img"]))
        paired[f"p_{side}"] = {k: v.numpy() for k, v in p.items()}
        paired[f"ang_{side}"] = ang.numpy()
    root = tmp_path_factory.mktemp("world")
    path = str(root / "world.pt")
    torch.save({"models": w["port"], "inputs": {
        case: {k: tree_t(v) for k, v in x.items()} for case, x in w["inputs"].items()}}, path)
    w["ranks"] = launch(pw.run_rank, pw.WORLD, path, str(root), backend="gloo", timeout=300)
    w["root"] = root
    return w


def tree_t(x):
    return {k: t(v) for k, v in x.items()} if isinstance(x, dict) else t(x)


def one_process(world, builder, case, *extra, gen=None, grads_only=False, scale=1.0, **kw):
    """The port's one-process step of ``case``'s arguments on the whole
    batch (A from seed 8, its weight × ``scale``): the optimizer step's
    (terms, gradient), or the grads-only step's."""
    args = dataclasses.replace(pw.case_args(case), grad_accum=1)
    a = init_direction_matrix(8, device="cpu")
    with torch.no_grad():
        a.linear.weight.mul_(scale)
    if grads_only:
        return builder(world["port"], pw.SPEC, args, grads_only=True, **kw)(a, gen, *extra)
    terms = builder(world["port"], pw.SPEC, args, make_optimizer(a, args), **kw)(a, gen,
                                                                                *extra)
    return ({k: float(v) for k, v in terms.items()},
            {n.split(".")[-1]: p.grad for n, p in a.named_parameters()})


def witness(world, builder, case, *extra, gen_seed=None, **kw):
    """The port's gradient does not jump under a 1e-6 relative change of A
    (rtol 1e-3, atol 1e-3·max): no comparison can hold beside a kink of
    the L1 losses."""
    def gen():
        return None if gen_seed is None else torch.Generator().manual_seed(gen_seed)
    g0 = one_process(world, builder, case, *extra, gen=gen(), grads_only=True, **kw)[1]
    g1 = one_process(world, builder, case, *extra, gen=gen(), grads_only=True,
                     scale=1 + 1e-6, **kw)[1]
    close_scaled(g1["weight"], g0["weight"].numpy(), 1e-3, 1e-3)


def test_world_ranks_import_no_jax(world):
    assert [jax_in for _, jax_in in world["ranks"]] == [False, False]


def test_world_paired_step_matches_jax(world):
    """The world's averaged gradient and mean terms against the JAX
    package's one-device paired step on the same batch of 2, both fed the
    same cached coefficients (the port's shape program's). The batch is
    ``tests/test_torch_train_steps.py``'s: on the one this world took
    before, some 30 of the bias gradient's entries jump by 1.8e-3 of its
    max between float32 runs (thread count, rows a call), the JAX package's
    own step and the port's one-process step alike sit there against the
    float64 step, and A's 1e-6 witness does not see it
    (``tests/torch_paired_rounding.py`` prints the readings)."""
    inputs = world["inputs"]["paired"]
    extra = [tree_t(inputs[k]) for k in pw.CACHED]
    witness(world, make_paired_step, "paired", *extra, cached_shape=True)
    jargs = JArgs(**{**pw.COMMON, "batch_size": 2, "training_method": "paired"})
    a = init_direction_matrix(8, device="cpu")
    a_jax = {"weight": a.linear.weight.detach().numpy().copy(),
             "bias": a.linear.bias.detach().numpy().copy(),
             "meta": {"shift_dim": 512, "input_dim": 15, "w_plus": True, "num_layers": 8}}
    jstep = jsteps.make_paired_step(world["jax"], j_dirs("voxceleb", 15, 6.0), jargs,
                                    jsteps.make_optimizer(jargs), grads_only=True,
                                    cached_shape=True)
    want, want_g = jstep(a_jax, jax.random.PRNGKey(0), *(inputs[k] for k in pw.CACHED))
    for terms, grads, _ in (r[0]["paired"] for r in world["ranks"]):
        assert set(terms) == set(want) | {"grad_norm"}
        for k in want:
            np.testing.assert_allclose(terms[k], float(want[k]), rtol=1e-4, err_msg=k)
        for k in ("weight", "bias"):
            close_scaled(grads[k], want_g[k], 1e-3, 1e-3)


def test_world_synthetic_step_matches_one_process(world):
    """Every rank draws batch 4 from generator seed 5 and keeps its block
    of each disentanglement-50 half: the world's step is the one-process
    step on the same seed."""
    witness(world, make_synthetic_step, "synthetic", gen_seed=5)
    want, want_g = one_process(world, make_synthetic_step, "synthetic",
                               gen=torch.Generator().manual_seed(5))
    for terms, grads, _ in (r[0]["synthetic"] for r in world["ranks"]):
        assert set(terms) == set(want)
        for k in want:
            rtol = 1e-3 if k == "grad_norm" else 1e-4      # a gradient, not a loss term
            np.testing.assert_allclose(terms[k], want[k], rtol=rtol, err_msg=k)
        for k in ("weight", "bias"):
            close_scaled(grads[k], want_g[k].numpy(), 1e-3, 1e-3)


def test_world_grad_accum_matches_the_whole_batch(world):
    """grad_accum 2 over the world: two microbatches of 2 (a row a rank),
    one reduction, one update, against the one-process batch-4 step."""
    extra = [t(world["inputs"]["accum"][k]) for k in pw.UNCACHED]
    witness(world, make_paired_step, "accum", *extra)
    want, want_g = one_process(world, make_paired_step, "accum", *extra)
    (t0, g0, a0), (t1, g1, a1) = (r[0]["accum"] for r in world["ranks"])
    assert all(torch.equal(a0[k], a1[k]) for k in a0)     # one A on every rank
    for k in want:
        rtol = 1e-3 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(t0[k], want[k], rtol=rtol, err_msg=k)
    for k in ("weight", "bias"):
        close_scaled(g0[k], want_g[k].numpy(), 1e-3, 1e-3)


def test_world_trainer_saves_on_rank_0_only(world):
    """Two Trainer steps with a save and an evaluation every step: rank 0
    writes its arguments, two log lines, step 1's A and the evaluations'
    metrics and grids; rank 1 writes nothing; the ranks' A are equal bit
    for bit and rank 0's file holds it."""
    from stylegan_directions_face_reenactment_tpu_torch.train import load_a_matrix
    r0, r1 = world["root"] / "rank0", world["root"] / "rank1"
    assert not r1.exists()
    assert sorted(os.listdir(r0 / "models")) == ["A_matrix_000001.npz"]
    assert len((r0 / "logs" / "train_log.jsonl").read_text().splitlines()) == 2
    a0, a1 = (r[0]["trainer"] for r in world["ranks"])
    assert all(torch.equal(a0[k], a1[k]) for k in a0)
    assert not torch.equal(a0["weight"], init_direction_matrix(0, device="cpu").linear.weight)
    step, saved, _ = load_a_matrix(str(r0 / "models" / "A_matrix_000001.npz"), "cpu")
    assert step == 1 and torch.equal(saved.linear.weight, a0["weight"])
    # the evaluations' files: rank 0's
    assert [m["step"] for m in json.loads((r0 / "logs" / "eval_metrics.json").read_text())
            ] == [0, 1, 2]
    assert sorted(os.listdir(r0 / "images")) == ["0000_reenactment.png",
                                                 "0001_reenactment.png"]


def test_world_trainer_evaluation_matches_one_process(world, tmp_path):
    """Each rank's evaluation at step 1 (the final A; two batches of 2, a
    row a rank, each batch's three means averaged over the world) and of a
    batch of 3 (it does not divide the world: whole on every rank) against
    the one-process ``Trainer.evaluate`` on the same A and samples: rtol
    1e-4, atol 1e-6."""
    from stylegan_directions_face_reenactment_tpu_torch.train import Trainer
    a = init_direction_matrix(0, device="cpu")
    with torch.no_grad():
        for n, p in a.named_parameters():
            p.copy_(world["ranks"][0][0]["trainer"][n.split(".")[-1]])
    args = dataclasses.replace(pw.case_args("trainer"), experiment_path=str(tmp_path))
    trainer = Trainer(args, world["port"], log_fn=lambda s: None)
    want = {1: trainer.evaluate(a, step=1, save_figure=False)}
    trainer.args = dataclasses.replace(args, test_batch_size=3)
    want[2] = trainer.evaluate(a, step=2, num_samples=3, save_figure=False)
    for out, _ in world["ranks"]:
        got = {m["step"]: m for m in out["trainer_metrics"]}
        assert sorted(got) == [0, 1, 2]
        for step, metrics in want.items():
            for k, v in metrics.items():
                np.testing.assert_allclose(got[step][k], v, rtol=1e-4, atol=1e-6,
                                           err_msg=f"step {step} {k}")
