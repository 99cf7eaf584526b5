"""The port's ``utils/profiling.py`` against the JAX package's: ``StepTimer``
on one fake clock (the same keys and values, exactly), and ``trace`` writing
a Chrome trace on the CPU. Then what the port adds: the reenactment
entries' span tree under ``torch.profiler`` and nothing without one, the
kernels' counters and ``counters.json``, on a tiny world on the CPU (a 32²
generator, A, the DECA ResNet-50, a 1-module FAN and S3FD, seeded; one raw
128² frame)."""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stylegan_directions_face_reenactment_tpu.utils import profiling as jprof

from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
from stylegan_directions_face_reenactment_tpu_torch.models.face import fan as fan_mod
from stylegan_directions_face_reenactment_tpu_torch.models.face.fan import fan_forward
from stylegan_directions_face_reenactment_tpu_torch.ops import fused_conv_block as k3
from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
    make_fused_reenact_fn, make_reenact_fn)
from stylegan_directions_face_reenactment_tpu_torch.pipeline.reenactment import k3_blocks
from stylegan_directions_face_reenactment_tpu_torch.utils import StepTimer, profiling, trace
from stylegan_directions_face_reenactment_tpu_torch.weights import (
    init_deca, init_direction_matrix, init_fan, init_generator, init_s3fd)
from torch_threads import _threads  # noqa: F401


def fake_clock(monkeypatch, step_s):
    """perf_counter reads 0, then advances by the next step's seconds at
    every second read (a step reads it twice)."""
    state = {"t": 0.0, "reads": 0, "steps": list(step_s)}

    def perf_counter():
        state["reads"] += 1
        if state["reads"] % 2 == 0:
            state["t"] += state["steps"].pop(0)
        return state["t"]

    monkeypatch.setattr(time, "perf_counter", perf_counter)


@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_step_timer_matches_jax(monkeypatch, warmup):
    steps = [0.5, 0.010, 0.012, 0.011, 0.030, 0.009, 0.010, 0.013, 0.011, 0.012, 0.050]
    out = []
    for timer_cls in (StepTimer, jprof.StepTimer):
        fake_clock(monkeypatch, steps)
        timer = timer_cls(warmup=warmup)
        for _ in steps:
            with timer.step():
                pass
        out.append(timer.summary())
    assert out[0] == out[1]
    assert out[0]["steps"] == len(steps) - warmup
    assert StepTimer().summary() == jprof.StepTimer().summary() == {}


def test_step_timer_dump(tmp_path, monkeypatch):
    fake_clock(monkeypatch, [0.1, 0.2])
    timer = StepTimer(warmup=0)
    for _ in range(2):
        with timer.step():
            pass
    timer.dump(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == timer.summary()


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir) as d:
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    assert d == logdir
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert profiling.trace is trace


# --- the reenactment spans, the kernels' counters -----------------------------

STAGES = {"fused": ["reenact.inputs", "reenact.preprocess", "reenact.deca", "reenact.shift",
                    "reenact.synthesis", "reenact.outputs"],
          "crops": ["reenact.inputs", "reenact.deca", "reenact.shift", "reenact.synthesis"]}
LAUNCH_COUNTERS = ("upfirdn2d_cuda.launches", "upfirdn2d_bwd_cuda.launches",
                   "upfirdn2d_bwd_cuda.down2_launches", "fused_bias_act_cuda.launches",
                   "fused_bias_act_bwd_cuda.launches", "fused_conv_block_cuda.launches",
                   "fused_conv_block_bwd.launches", "filtered_lrelu_cuda.launches")


@pytest.fixture(scope="module")
def world():
    g = init_generator(1, size=32, channel_multiplier=1, device="cpu")
    a = init_direction_matrix(2, num_layers=6, device="cpu")
    rs = np.random.RandomState(0)
    src = (rs.randn(1, g.n_latent, 512).astype(np.float32),
           {"pose": (0.1 * rs.randn(1, 6)).astype(np.float32),
            "alpha_shp": rs.randn(1, 100).astype(np.float32),
            "alpha_exp": rs.randn(1, 50).astype(np.float32),
            "cam": rs.randn(1, 3).astype(np.float32)},
            np.float32([[5.0, -10.0, 2.0]]))
    return dict(nets=(g, a, init_deca(3, device="cpu")), fan=init_fan(4, 1, device="cpu"),
                sfd=init_s3fd(5, device="cpu"), src=src,
                trunc=torch.from_numpy(rs.randn(1, 512).astype(np.float32)),
                frames=rs.randint(0, 256, (1, 128, 128, 3)).astype(np.uint8),
                crops=rs.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32))


def _entry(world, kind):
    """A new entry of ``kind`` (its call counter at 0) and its input."""
    spec = initialize_directions("voxceleb", 15, 6.0)
    kw = dict(num_layers_shift=6, truncation_latent=world["trunc"], fan_params=world["fan"],
              s3fd_params=world["sfd"], device="cpu")
    if kind == "fused":
        return make_fused_reenact_fn(*world["nets"], spec, world["sfd"], world["fan"],
                                     **kw), world["frames"]
    return make_reenact_fn(*world["nets"], spec, **kw), world["crops"]


def _stage_of(ev):
    """The innermost ``reenact.*`` span around ``ev`` (itself included)."""
    while ev is not None and not ev.name.startswith("reenact."):
        ev = ev.cpu_parent
    return ev


@pytest.mark.parametrize("kind", ["fused", "crops"])
def test_a_call_is_one_span_tree(world, kind):
    fn, x = _entry(world, kind)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for _ in range(2):
            fn(*world["src"], x)
    events = prof.events()
    calls = [e for e in events if e.name == "reenact.call"]
    assert [e.kwinputs.get("call") for e in calls] == [0, 1]
    for call in calls:
        assert call.cpu_parent is None
        kids = sorted(call.cpu_children, key=lambda e: e.time_range.start)
        assert [e.name for e in kids] == STAGES[kind]
        assert all(not any(c.name.startswith("reenact.") for c in e.cpu_children)
                   for e in kids)
    spans = {e.name for e in events if e.name.startswith("reenact.")}
    assert spans == {"reenact.call", *STAGES[kind]}
    # every operator of a call runs inside exactly one stage
    ops = [e for e in events if e.name.startswith("aten::") and _stage_of(e) is not None]
    assert ops and all(_stage_of(e).name != "reenact.call" for e in ops)


def test_no_span_without_a_profiler(world, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span was opened with no profiler active")
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    fn, x = _entry(world, "crops")
    fn(*world["src"], x)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler"):
            with profiling.span("reenact.call"):
                pass


@pytest.mark.parametrize("inference_weights", [False, True])
def test_counters_and_k3_argument_builds(monkeypatch, inference_weights):
    """``args_built``: one build a ConvBlock on FAN's first pass, none on a
    second with the same weights; weights made under inference mode are
    built anew on every pass. The blocks go through ``block_args`` on the
    CPU as the gate sends them on the card."""
    keys = profiling.counters()
    assert set(LAUNCH_COUNTERS) | {"fused_conv_block.args_built",
                                   "fused_conv_block_cuda.plan_misses",
                                   "filtered_lrelu_cuda.plan_misses",
                                   "filtered_lrelu_cuda.nhwc_launches",
                                   "filtered_lrelu_cuda.prefetched_planes"} == set(keys)
    monkeypatch.setattr(fan_mod, "fused_convblock_enabled", lambda p, x: k3.k3_takes(p))
    with torch.inference_mode(inference_weights):
        fan = init_fan(6, 1, device="cpu")
    x = torch.rand(1, 256, 256, 3)
    n = len(k3_blocks(fan))
    built = []
    with torch.inference_mode():
        for _ in range(2):
            before = profiling.counters()["fused_conv_block.args_built"]
            fan_forward(fan, x)
            built.append(profiling.counters()["fused_conv_block.args_built"] - before)
    assert n == 14 and built == [n, n if inference_weights else 0]


def test_trace_writes_the_counters(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        k3.block_args(fan_mod.ConvBlock(256, 256), torch.float32)
    with open(os.path.join(logdir, "counters.json")) as f:
        got = json.load(f)
    assert set(got) == set(profiling.counters())
    assert got["fused_conv_block.args_built"] == 1
    assert all(v == 0 for k, v in got.items() if k != "fused_conv_block.args_built")
