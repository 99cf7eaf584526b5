"""The port's ``utils/profiling.py`` against the JAX package's: ``StepTimer``
on one fake clock (the same keys and values, exactly), and ``trace`` writing
a Chrome trace on the CPU."""

import json
import os
import time

import pytest
import torch

from stylegan_directions_face_reenactment_tpu.utils import profiling as jprof

from stylegan_directions_face_reenactment_tpu_torch.utils import StepTimer, profiling, trace
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
