"""The port's Trainer, datasets, evaluation metrics, checkpoints and
``run_trainer`` CLI on the CPU: port-side runs of each method on a tiny
VoxCeleb-layout tree, with the pieces that have a JAX counterpart held
against it (no JAX Trainer runs here; the JAX package marks those slow).

World: ``tests/torch_train_world.py`` with the resize alignment, batch 2.
The tree (1 identity, 1 video, 3 frames of 64² noise with W+ codes) is
made with numpy from a seed. Tolerances: the metrics rtol 1e-4; the
datasets and checkpoints exactly.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_directions_face_reenactment_tpu.data import datasets as jds
from stylegan_directions_face_reenactment_tpu.geometry import initialize_directions as jinit
from stylegan_directions_face_reenactment_tpu.train.checkpoints import (
    load_a_matrix as j_load_a_matrix)
from stylegan_directions_face_reenactment_tpu.train.eval import (
    extract_evaluation_metrics as j_metrics)

from stylegan_directions_face_reenactment_tpu_torch.cli import model_loading, run_trainer
from stylegan_directions_face_reenactment_tpu_torch.configs import TrainingArguments
from stylegan_directions_face_reenactment_tpu_torch.data import datasets as pds
from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
from stylegan_directions_face_reenactment_tpu_torch.train import (
    Trainer, extract_evaluation_metrics, load_a_matrix, save_a_matrix)
from stylegan_directions_face_reenactment_tpu_torch.weights import init_direction_matrix

from torch_face_zoo import statics_jit
from torch_train_world import DECA_SIZE, N_LAT, SIZE, build_train_world, t, torch_threads

SPEC = initialize_directions()


_threads = pytest.fixture(scope="module", autouse=True)(torch_threads)


@pytest.fixture(scope="module")
def world():
    return build_train_world()


def make_tree(root, n_ids=1, n_videos=1, n_frames=3):
    rs = np.random.RandomState(0)
    for i in range(n_ids):
        for v in range(n_videos):
            base = os.path.join(root, f"id{i:05d}", f"video{v}")
            dirs = [os.path.join(base, "frames_cropped"),
                    os.path.join(base, "inversion", "frames"),
                    os.path.join(base, "inversion", "latent_codes")]
            for d in dirs:
                os.makedirs(d, exist_ok=True)
            for f in range(n_frames):
                img = Image.fromarray((rs.rand(SIZE, SIZE, 3) * 255).astype(np.uint8))
                img.save(os.path.join(dirs[0], f"{f:06d}.png"))
                img.save(os.path.join(dirs[1], f"{f:06d}.png"))
                np.save(os.path.join(dirs[2], f"{f:06d}.npy"),
                        (0.5 * rs.randn(N_LAT, 512)).astype(np.float32))
    return root


def targs(tmp_path, **kw):
    base = dict(batch_size=2, test_batch_size=2, image_resolution=SIZE,
                deca_alignment="resize", deca_image_size=DECA_SIZE,
                experiment_path=str(tmp_path / "exp"),
                steps_per_log=1, validation_samples=2, num_pairs_log=2, evaluation=False)
    return TrainingArguments(**{**base, **kw})


def log_lines(tmp_path):
    return [json.loads(x) for x in
            (tmp_path / "exp" / "logs" / "train_log.jsonl").read_text().splitlines()]


def test_trainer_synthetic_two_steps_saves_and_evaluates(tmp_path, world):
    """Two steps with a save at step 1, the evaluation at step 0 (grid,
    metrics file) and the GIF."""
    args = targs(tmp_path, steps_per_save=1, evaluation=True, steps_per_ev_log=2, gif=True)
    a0 = init_direction_matrix(0, device="cpu").linear.weight.detach().clone()
    a = Trainer(args, world["port"], log_fn=lambda s: None).train(0, n_steps=2)
    assert not torch.equal(a.linear.weight.detach(), a0)
    assert [r["step"] for r in log_lines(tmp_path)] == [0, 1]
    assert {"loss", "loss_shape", "loss_identity", "grad_norm"} <= set(log_lines(tmp_path)[0])
    exp = tmp_path / "exp"
    assert sorted(os.listdir(exp / "models")) == ["A_matrix_000001.npz"]
    assert (exp / "images" / "0000_reenactment.png").exists()
    assert (exp / "images" / "0000_directions.gif").exists()
    metrics = json.loads((exp / "logs" / "eval_metrics.json").read_text())
    assert metrics[0]["step"] == 0 and all(np.isfinite(metrics[0][k]) for k in
                                           ("csim", "pose_error", "expression_error"))
    assert json.loads((exp / "arguments.json").read_text())["batch_size"] == 2


@pytest.mark.parametrize("method", ["paired", "real", "real_synthetic"])
def test_trainer_epoch_on_a_tree(tmp_path, world, method):
    """One epoch of each dataset method, with the coefficient cache and,
    for paired, without it too, and the paired evaluation."""
    data = make_tree(str(tmp_path / "data"))
    kw = dict(training_method=method, train_dataset_path=data, test_dataset_path=data)
    if method == "paired":
        kw.update(evaluation=True, steps_per_ev_log=1)
    tr = Trainer(targs(tmp_path, **kw), world["port"], log_fn=lambda s: None)
    run = tr.train_paired if method == "paired" else tr.train_real
    a = run(0, n_epochs=1)
    assert torch.isfinite(a.linear.weight).all()
    lines = log_lines(tmp_path)
    # batches an epoch: 2 pairs / 2; 3 frames / 2; 3 frames / the real half of 1
    n = {"paired": 1, "real": 1, "real_synthetic": 3}[method]
    assert [r["step"] for r in lines] == list(range(n)) and lines[0]["epoch"] == 0
    if method == "paired":
        assert "loss_pixel_wise" in lines[0]
        assert (tmp_path / "exp" / "images" / "0000_reenactment.png").exists()
        tr.args.cache_gt_shape = False
        assert torch.isfinite(tr.train_paired(0, n_epochs=1).linear.weight).all()


def test_gt_shape_cache_fills_once_and_hits(tmp_path, world):
    """The paired cache runs one shape pass for a batch with a miss, and
    none for a batch whose frames it holds."""
    tr = Trainer(targs(tmp_path), world["port"], log_fn=lambda s: None)
    calls = []

    def shape_fn(imgs):
        calls.append(imgs.shape[0])
        b = imgs.shape[0]
        return ({k: imgs.reshape(b, -1)[:, :n] for k, n in
                 (("pose", 6), ("alpha_shp", 100), ("alpha_exp", 50), ("cam", 3))},
                imgs.reshape(b, -1)[:, :3])

    rs = np.random.RandomState(0)
    batch = {"source_path": ["a", "b"], "target_path": ["b", "c"],
             "source_img": rs.rand(2, 8, 8, 3).astype(np.float32),
             "target_img": rs.rand(2, 8, 8, 3).astype(np.float32)}
    cache = {}
    first = tr._gt_shape_for_batch(shape_fn, cache, batch)
    again = tr._gt_shape_for_batch(shape_fn, cache, batch)
    assert calls == [4] and set(cache) == {"a", "b", "c"}
    for x, y in zip(first, again):
        if isinstance(x, dict):
            assert all(torch.equal(x[k], y[k]) for k in x)
        else:
            assert torch.equal(x, y)
    # "b" is the first batch's target and the second's source: one entry
    assert torch.equal(first[0]["pose"][1], first[2]["pose"][0])


def test_datasets_draw_the_jax_packages_samples(tmp_path):
    data = make_tree(str(tmp_path / "data"), n_ids=2, n_videos=2, n_frames=4)
    for cls in ("CustomDatasetPaired", "CustomDatasetPairedValidation"):
        jd = getattr(jds, cls)(data, seed=3, image_size=SIZE)
        pdd = getattr(pds, cls)(data, seed=3, image_size=SIZE)
        for _ in range(2):
            assert jd.samples == pdd.samples and len(jd) == len(pdd) == 8
            for i in range(len(jd)):
                js, ps = jd[i], pdd[i]
                assert set(js) == set(ps)
                for k in js:
                    assert np.array_equal(js[k], ps[k]), (cls, i, k)
            if cls == "CustomDatasetPaired":
                jd.resample()
                pdd.resample()
    jr, pr = jds.CustomDatasetTestsetReal(data, 5), pds.CustomDatasetTestsetReal(data, 5)
    assert list(jr.w) == list(pr.w)
    assert np.array_equal(jr.fixed_target_w, pr.fixed_target_w)
    assert np.array_equal(jr[2]["source_w"], pr[2]["source_w"])
    js, ps = jds.CustomDatasetTestsetSynthetic(num_samples=3), pds.CustomDatasetTestsetSynthetic(
        num_samples=3)
    assert np.array_equal(js.fixed_source_w, ps.fixed_source_w)
    jc, pc = jds.CustomDataset(data, SIZE), pds.CustomDataset(data, SIZE)
    assert jc.get_length() == pc.get_length() == (16, 2, 4)
    for k, v in jc[5].items():
        assert np.array_equal(v, pc[5][k]), k


@pytest.mark.parametrize("batch0_only", [False, True])
def test_evaluation_metrics_match_jax(world, batch0_only):
    rs = np.random.RandomState(5)

    def coeffs():
        return {"pose": (0.2 * rs.randn(3, 6)).astype(np.float32),
                "alpha_shp": rs.randn(3, 100).astype(np.float32),
                "alpha_exp": rs.randn(3, 50).astype(np.float32),
                "cam": rs.randn(3, 3).astype(np.float32)}

    p_sh, p_tgt = coeffs(), coeffs()
    ang_sh, ang_tgt = ((20 * rs.randn(3, 3)).astype(np.float32) for _ in range(2))
    imgs = [rs.uniform(-1, 1, (3, 256, 256, 3)).astype(np.float32) for _ in range(2)]
    want = statics_jit(lambda idb, *xs: j_metrics(jinit("voxceleb", 15, 6.0), idb, *xs,
                                                  batch0_only=batch0_only),
                       world["jax"].id_backbone)(p_sh, p_tgt, ang_sh, ang_tgt, *imgs)
    with torch.no_grad():
        got = extract_evaluation_metrics(SPEC, world["port"].id_backbone,
                                         {k: t(v) for k, v in p_sh.items()},
                                         {k: t(v) for k, v in p_tgt.items()}, t(ang_sh),
                                         t(ang_tgt), *(t(x) for x in imgs),
                                         batch0_only=batch0_only)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4)


def test_checkpoint_is_read_by_both_packages_and_resumes(tmp_path, world):
    a = init_direction_matrix(3, device="cpu")
    path = save_a_matrix(str(tmp_path / "models"), a, 7, 15, 6.0, True, 8)
    step, ja, meta = j_load_a_matrix(path)
    assert step == 7 and meta["num_layers_shift"] == 8
    assert np.array_equal(np.asarray(ja["weight"]), a.linear.weight.detach().numpy())
    assert np.array_equal(np.asarray(ja["bias"]), a.linear.bias.detach().numpy())
    for got in (model_loading.load_direction_matrix(path=path, device="cpu"),
                load_a_matrix(path, "cpu")[1]):
        assert torch.equal(got.linear.weight, a.linear.weight)
    # the reference's torch bundle
    pt = str(tmp_path / "ref.pt")
    torch.save({"step": 4, "A_matrix": a.state_dict(), "learned_directions": 15,
                "shift_scale": 6.0, "w_plus": True, "num_layers_shift": 8}, pt)
    step, got, _ = load_a_matrix(pt, "cpu")
    assert step == 4 and torch.equal(got.linear.bias, a.linear.bias)
    # a resumed run starts at the bundle's step (the reference restarts at 0)
    args = targs(tmp_path, resume_training_model=path, steps_per_save=1000)
    out = Trainer(args, world["port"], log_fn=lambda s: None).train(0, n_steps=9)
    assert [r["step"] for r in log_lines(tmp_path)] == [7, 8]
    assert not torch.equal(out.linear.weight, a.linear.weight)


def test_run_trainer_main_on_the_cpu(tmp_path):
    trainer, a = run_trainer.main([
        "--random_init", "--device", "cpu", "--image_resolution", str(SIZE),
        "--batch_size", "2", "--n_steps", "1", "--deca_alignment", "resize",
        "--no_evaluation", "--experiment_path", str(tmp_path / "run")])
    out = tmp_path / "run_voxceleb_synthetic"
    assert trainer.args.experiment_path == str(out)
    assert (out / "arguments.json").exists() and (out / "logs" / "train_log.jsonl").exists()
    assert a.linear.weight.device.type == "cpu" and torch.isfinite(a.linear.weight).all()


@pytest.mark.parametrize("flags", [["--n_devices", "2"], ["--dcn_slices", "2"]])
def test_run_trainer_over_several_cards(tmp_path, monkeypatch, flags):
    """``--n_devices 2`` spawns a gloo world of 2 CPU processes for one
    step of the global batch 4 (a row of each disentanglement-50 half a
    rank) and returns rank 0's A; rank 0 alone writes the files.
    ``--dcn_slices 2`` takes its world from torchrun's environment and
    raises without it."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--random_init", "--device", "cpu", "--image_resolution", str(SIZE),
            "--n_steps", "1", "--deca_alignment", "resize", "--no_evaluation",
            "--experiment_path", str(tmp_path / "run"), *flags]
    if "--dcn_slices" in flags:
        with pytest.raises(ValueError, match="torchrun"):
            run_trainer.main(argv)
        return
    with pytest.raises(ValueError, match="must divide the mesh"):
        run_trainer.main(argv + ["--batch_size", "3"])
    trainer, a = run_trainer.main(argv + ["--batch_size", "4"])
    out = tmp_path / "run_voxceleb_synthetic"
    assert trainer is None and a.linear.weight.device.type == "cpu"
    assert torch.isfinite(a.linear.weight).all()
    # A drawn from --seed 0, then one update
    assert not torch.equal(a.linear.weight, init_direction_matrix(0, device="cpu").linear.weight)
    assert len((out / "logs" / "train_log.jsonl").read_text().splitlines()) == 1


def test_run_trainer_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_trainer.main(["--random_init"])
