"""The port's serving bundle (``serving.py``, ``cli/export_serving.py``) on
the CPU, against the port's live ``make_reenact_fn`` and the JAX package's.

The set-up is ``tests/torch_reenact_world.py`` (a 64² generator, channel
multiplier 1; A; the DECA ResNet-50; a 2-module FAN and the boosted S3FD),
the JAX weights carried into the port with the ``*_from_jax`` converters;
the bundles' frame batch is 4 and the targets are 256² crops in [-1, 1]
made with numpy from a seed. Each program is exported, and the JAX
program built, once a module.

Tolerances: a request of exactly one chunk against the live call within
1e-6·max (the same operators on the same batch; read 0); requests padded
or cut into chunks run other batch sizes, whose convolutions sum in
other orders: rtol 1e-5, atol 1e-5·max; against the JAX package, the
bounds of ``tests/test_torch_reenact.py`` (images rtol 1e-3, atol
2e-4·max; latents rtol 1e-4, atol 1e-4·max).
"""

import json
import os
import shutil
import subprocess
import sys
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.geometry.directions import (
    initialize_directions as j_initialize_directions)
from stylegan_directions_face_reenactment_tpu.pipeline.reenactment import (
    make_reenact_fn as j_make_reenact_fn)

import stylegan_directions_face_reenactment_tpu_torch as port_pkg
from stylegan_directions_face_reenactment_tpu_torch import serving
from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
from stylegan_directions_face_reenactment_tpu_torch.ops.main_path import (
    fused_bias_act_calls, fused_conv_block_calls, upfirdn2d_calls)
from stylegan_directions_face_reenactment_tpu_torch.pipeline import make_reenact_fn
from stylegan_directions_face_reenactment_tpu_torch.weights import init_generator

from torch_reenact_world import SIZE, build_world, close_scaled

FB = 4
WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(port_pkg.__file__)))
SPEC = initialize_directions("voxceleb", 15, 6.0)


def ops_in(ep) -> Counter:
    return Counter(str(n.target) for n in ep.graph.nodes if str(n.target).startswith("sdfr."))


def close(got, want, atol_rel=1e-6, rtol=0.0):
    if isinstance(want, dict):
        for k in want:
            close(got[k], want[k], atol_rel, rtol)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


CHILD = """
import json, pickle, sys
import numpy as np, torch

def refuse(*a, **k):
    raise AssertionError("pickle read while loading a bundle")
real_load = torch.load

def torch_load(*a, **k):
    assert k.get("weights_only", True) is not False, "torch.load(weights_only=False)"
    return real_load(*a, **k)
pickle.load, pickle.loads, torch.load = refuse, refuse, torch_load
torch.set_num_threads(1)        # beside the tests' own threads
from stylegan_directions_face_reenactment_tpu_torch import serving
inp = np.load(sys.argv[1])
src = (inp["code"], {k: inp["ps_" + k] for k in ("pose", "alpha_shp", "alpha_exp", "cam")},
       inp["ang"])
prog = serving.load_reenact_bundle(sys.argv[3])
shapes = {k: list(v.shape) for k, v in prog.weights["deca"].items()}
img, lat = prog(*src, inp["tgts"])
np.savez(sys.argv[2], img=img.numpy(), lat=lat.numpy())
pkg = "stylegan_directions_face_reenactment_tpu_torch"
bad = [m for m in sys.modules if m.startswith((pkg + ".models", pkg + ".pipeline", "jax"))]
print(json.dumps({"bad": bad, "deca_shapes": shapes}))
"""


@pytest.fixture(scope="module", autouse=True)
def threads():
    """torch's threads: the cores over the xdist workers, less one for the
    server process (its single thread beside them would stall the others'
    OpenMP barriers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS - 1))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world(tmp_path_factory, threads):
    """The world and its resize bundle, saved and loaded; the CLI's bundle,
    and a fresh server process (one thread) that loads it and serves one
    request of ``FB`` frames while the tests run."""
    from stylegan_directions_face_reenactment_tpu_torch.cli import export_serving
    w = build_world()
    rs = np.random.RandomState(21)
    w["tgts"] = rs.uniform(-1, 1, (7, 256, 256, 3)).astype(np.float32)
    w["lms"] = (rs.rand(7, 68, 2) * 110 + 70).astype(np.float32)
    w["ok"] = np.array([True, False, True, True, False, True, True])
    w["trunc_t"] = torch.from_numpy(w["trunc"])
    w["src"] = (w["code"], w["ps"], w["ang"])
    g, a, deca, _, _ = w["port"]
    ep, weights, meta = serving.export_reenact(g, a, deca, SPEC, frame_batch=FB,
                                               truncation_latent=w["trunc_t"],
                                               platforms=("cpu",))
    tmp = tmp_path_factory.mktemp("serving")
    w["ep"], w["dir"], w["cli_dir"] = ep, str(tmp / "bundle"), str(tmp / "cli_bundle")
    serving.save_reenact_bundle(w["dir"], ep, weights, meta)
    w["served"] = serving.load_reenact_bundle(w["dir"])
    export_serving.main(["--output_path", w["cli_dir"], "--random_init", "--deca_alignment",
                         "resize", "--image_resolution", "64", "--frame_batch", "2",
                         "--platforms", "cpu"])
    inputs, w["child_out"] = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(inputs, code=w["code"], ang=w["ang"], tgts=w["tgts"][:FB],
             **{"ps_" + k: v for k, v in w["ps"].items()})
    w["child"] = subprocess.Popen([sys.executable, "-c", CHILD, inputs, w["child_out"],
                                   w["cli_dir"]], cwd=ROOT,
                                  env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    w["live"] = make_reenact_fn(g, a, deca, SPEC, truncation_latent=w["trunc_t"], device="cpu")
    yield w
    w["child"].kill()
    shutil.rmtree(tmp, ignore_errors=True)      # two bundles of some 200 MB each


def child_result(world):
    """The server process's report and outputs (waits for it once)."""
    if "child_report" not in world:
        out, err = world["child"].communicate(timeout=300)
        assert world["child"].returncode == 0, out + err
        world["child_report"] = json.loads(out.strip().splitlines()[-1])
        world["child_arrays"] = dict(np.load(world["child_out"]))
    return world["child_report"], world["child_arrays"]


@pytest.mark.parametrize("t", [1, 3, 7])
def test_requests_are_chunked_and_padded(world, t):
    img, lat = world["served"](*world["src"], world["tgts"][:t])
    want_img, want_lat = world["live"](*world["src"], world["tgts"][:t])
    assert img.shape[0] == lat.shape[0] == t
    close(img, want_img, 1e-5, 1e-5)
    close(lat, want_lat, 1e-5, 1e-5)


def test_empty_request_raises(world):
    with pytest.raises(ValueError, match="empty"):
        world["served"](*world["src"], world["tgts"][:0])


def test_exported_graph_calls_the_operators(world):
    assert ops_in(world["ep"]) == Counter({
        "sdfr.upfirdn2d.default": len(upfirdn2d_calls(SIZE, 1, FB)),
        "sdfr.fused_bias_act.default": len(fused_bias_act_calls(SIZE, 1, FB))})


def _meta_only(world, d, **change):
    d.mkdir()
    with open(os.path.join(world["dir"], serving.META_FILE)) as f:
        meta = dict(json.load(f), **change)
    (d / serving.META_FILE).write_text(json.dumps(meta))
    return str(d)


def test_wrong_platform_or_format_is_refused(world, tmp_path):
    assert world["served"].platforms == ("cpu",)
    with pytest.raises(ValueError, match="platforms"):
        serving.load_reenact_bundle(_meta_only(world, tmp_path / "a", platforms=["cuda"]))
    with pytest.raises(ValueError, match="format_version"):
        serving.load_reenact_bundle(_meta_only(world, tmp_path / "b", format_version=2))
    with pytest.raises(ValueError, match="one platform"):
        serving.export_reenact(*world["port"][:3], SPEC, platforms=("cuda", "cpu"))


def test_with_generator(world):
    g2 = init_generator(5, size=SIZE, channel_multiplier=1, device="cpu")
    _, a, deca, _, _ = world["port"]
    img, _ = world["served"].with_generator(g2)(*world["src"], world["tgts"][:FB])
    want, _ = make_reenact_fn(g2, a, deca, SPEC, truncation_latent=world["trunc_t"],
                              device="cpu")(*world["src"], world["tgts"][:FB])
    close(img, want)
    base, _ = world["served"](*world["src"], world["tgts"][:FB])
    assert float((img - base).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="architecture"):
        world["served"].with_generator(init_generator(5, size=32, channel_multiplier=1,
                                                      device="cpu"))


def _in_memory(ep, weights, meta):
    return serving.ReenactServingProgram(ep, weights, meta, torch.device("cpu"))


def test_fan_bundle_with_target_params(world):
    """The SFD → FAN alignment (K3 in the graph, 14 blocks a FAN module) and
    ``return_target_params``: the coefficients' dict sliced like the rest."""
    g, a, deca, fan, sfd = world["port"]
    kw = dict(truncation_latent=world["trunc_t"], fan_params=fan, s3fd_params=sfd,
              return_target_params=True)
    ep, weights, meta = serving.export_reenact(g, a, deca, SPEC, frame_batch=FB,
                                               platforms=("cpu",), **kw)
    assert meta["deca_alignment"] == "fan" and meta["return_target_params"]
    assert ops_in(ep)["sdfr.fused_conv_block.default"] == len(
        fused_conv_block_calls(FB, num_modules=fan.num_modules))
    served = _in_memory(ep, weights, meta)
    live = make_reenact_fn(g, a, deca, SPEC, device="cpu", **kw)
    got, want = served(*world["src"], world["tgts"][:3]), live(*world["src"], world["tgts"][:3])
    assert set(got[2]) == set(want[2]) and all(v.shape[0] == 3 for v in got[2].values())
    for x, y in zip(got, want):
        close(x, y, 1e-5, 1e-5)


def test_reuse_landmarks_bundle(world):
    g, a, deca, fan, _ = world["port"]
    kw = dict(truncation_latent=world["trunc_t"], fan_params=fan, reuse_landmarks=True)
    ep, weights, meta = serving.export_reenact(g, a, deca, SPEC, frame_batch=FB,
                                               platforms=("cpu",), **kw)
    assert meta["reuse_landmarks"] and "sdfr.fused_conv_block.default" not in ops_in(ep)
    served = _in_memory(ep, weights, meta)
    live = make_reenact_fn(g, a, deca, SPEC, device="cpu", **kw)
    extra = (world["lms"][:3], world["ok"][:3])
    for x, y in zip(served(*world["src"], world["tgts"][:3], *extra),
                    live(*world["src"], world["tgts"][:3], *extra)):
        close(x, y, 1e-5, 1e-5)


# --- the bundle's round trip; the server process (it ran meanwhile) ----------

def test_round_trip_matches_the_live_program(world):
    """The bundle saved, loaded and served, against the live program."""
    want_img, want_lat = world["live"](*world["src"], world["tgts"][:FB])
    img, lat = world["served"](*world["src"], world["tgts"][:FB])
    assert img.shape == (FB, SIZE, SIZE, 3) and lat.shape == (FB, 10, 512)
    close(img, want_img)
    close(lat, want_lat)


def test_export_under_a_profiler_holds_no_span(world):
    """Exported while a ``torch.profiler`` session records, the program's
    spans (``utils/profiling.py::span``) leave no node in the graph, which
    is the graph exported without one, and it serves what the live program
    computes."""
    from torch.profiler import ProfilerActivity, profile
    g, a, deca, _, _ = world["port"]
    with profile(activities=[ProfilerActivity.CPU]):
        ep, weights, meta = serving.export_reenact(g, a, deca, SPEC, frame_batch=FB,
                                                   truncation_latent=world["trunc_t"],
                                                   platforms=("cpu",))
    assert not any("profiler" in str(n.target) for n in ep.graph.nodes)
    assert [str(n.target) for n in ep.graph.nodes] == [
        str(n.target) for n in world["ep"].graph.nodes]
    want_img, want_lat = world["live"](*world["src"], world["tgts"][:FB])
    img, lat = _in_memory(ep, weights, meta)(*world["src"], world["tgts"][:FB])
    close(img, want_img)
    close(lat, want_lat)


def test_round_trip_matches_jax(world):
    jg, ja, jdeca, _, _ = world["jax"]
    fn = j_make_reenact_fn(jg, ja, jdeca, j_initialize_directions("voxceleb", 15, 6.0),
                           truncation_latent=jnp.asarray(world["trunc"]))
    want_img, want_lat = fn(*world["src"], world["tgts"][:FB])
    img, lat = world["served"](*world["src"], world["tgts"][:FB])
    close_scaled(img.numpy(), want_img, 1e-3, 2e-4)
    close_scaled(lat.numpy(), want_lat, 1e-4, 1e-4)


def test_weights_are_stored_without_pickle(world):
    """The weights are a plain npz (0-d leaves stay 0-d) and the program
    file holds none of them; the server process loaded the CLI's bundle with
    ``pickle`` refused and ``torch.load`` held to ``weights_only``."""
    d = world["dir"]
    assert sorted(os.listdir(d)) == sorted([serving.PROGRAM_FILE, serving.WEIGHTS_FILE,
                                            serving.WEIGHTS_TREE_FILE, serving.META_FILE])
    assert os.path.getsize(os.path.join(d, serving.PROGRAM_FILE)) < 8 << 20
    with np.load(os.path.join(d, serving.WEIGHTS_FILE), allow_pickle=False) as z:
        assert all(z[k].dtype != object for k in z.files)
    want = {k: tuple(v.shape) for k, v in world["port"][2].state_dict().items()}
    assert {k: tuple(v.shape) for k, v in world["served"].weights["deca"].items()} == want
    assert want["E_flame.encoder.bn1.num_batches_tracked"] == ()
    report, _ = child_result(world)
    assert report["deca_shapes"]["E_flame.encoder.bn1.num_batches_tracked"] == []


def test_export_serving_cli_and_a_server_without_model_code(world, capsys):
    """``cli/export_serving.main`` on random weights (resize alignment, 64²,
    frame batch 2, in the fixture); its bundle served in a fresh process
    that imports no ``models/`` or ``pipeline/`` module (nor JAX), against
    the live call on the CLI's weights (the server runs one thread, which
    sums oneDNN's convolutions in another order: rtol 1e-5, atol
    1e-5·max)."""
    from stylegan_directions_face_reenactment_tpu_torch.cli import export_serving
    from stylegan_directions_face_reenactment_tpu_torch.cli.model_loading import (
        compute_trunc, load_deca, load_direction_matrix, load_generator)
    with open(os.path.join(world["cli_dir"], serving.META_FILE)) as f:
        meta = json.load(f)
    assert (meta["frame_batch"], meta["generator_size"], meta["deca_alignment"],
            meta["platforms"], meta["dataset_type"]) == (2, 64, "resize", ["cpu"], "voxceleb")
    assert "torch_version" in meta and "jax_version" not in meta
    with pytest.raises(ValueError, match="reuse_landmarks"):
        export_serving.main(["--output_path", world["cli_dir"], "--deca_alignment", "resize",
                             "--reuse_landmarks"])
    report, arrays = child_result(world)
    assert report["bad"] == []
    g = load_generator("voxceleb", random_init=True, resolution=64, device="cpu")
    live = make_reenact_fn(g, load_direction_matrix(random_init=True, device="cpu"),
                           load_deca(random_init=True, device="cpu"), SPEC,
                           truncation_latent=compute_trunc(g), device="cpu")
    want_img, want_lat = live(*world["src"], world["tgts"][:FB])
    close(arrays["img"], want_img, 1e-5, 1e-5)
    close(arrays["lat"], want_lat, 1e-5, 1e-5)
