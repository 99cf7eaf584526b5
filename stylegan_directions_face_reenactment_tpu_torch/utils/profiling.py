"""Profiling and step timing (the JAX package's ``utils/profiling.py``; the
reference has none).

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, loadable in Perfetto or
  ``chrome://tracing``), the card's kernels included where there is one;
* :class:`StepTimer`: wall-clock step timing with percentile summaries, for
  a training loop's observability without a profiler. On the card each
  step ends with ``torch.cuda.synchronize()``, so that a step's time is its
  work and not the time to queue it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List


@contextlib.contextmanager
def trace(logdir: str = "reenact_trace"):
    """Capture a trace: ``with trace('out/t'): step()`` writes
    ``out/t/trace.json``; the context yields ``logdir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock step timer with summary stats: the JAX package's keys and
    semantics (the first ``warmup`` steps are not counted).

    Usage::

        timer = StepTimer()
        for batch in loader:
            with timer.step():
                out = step_fn(...)
        print(timer.summary())
    """

    def __init__(self, warmup: int = 1):
        self.times: List[float] = []
        self.warmup = warmup
        self._seen = 0

    @staticmethod
    def _sync():
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def step(self):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_ms": sum(ts) / n * 1e3,
            "p50_ms": ts[n // 2] * 1e3,
            "p90_ms": ts[int(n * 0.9)] * 1e3,
            "min_ms": ts[0] * 1e3,
            "max_ms": ts[-1] * 1e3,
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
