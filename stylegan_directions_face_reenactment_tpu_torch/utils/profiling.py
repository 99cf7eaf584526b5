"""Profiling and step timing (the JAX package's ``utils/profiling.py``; the
reference has none).

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, loadable in Perfetto or
  ``chrome://tracing``), the card's kernels included where there is one,
  and how each of :func:`counters` changed over it (``counters.json``);
* :func:`span`: a named span of the program in the profiler's trace, on
  the device kernels' clock; nothing at all when no profiler is active.
  The reenactment entries (``pipeline/reenactment.py``) open one
  ``reenact.call`` a call, its ``call`` argument counting the entry's
  calls, and under it the stages ``reenact.inputs``,
  ``reenact.preprocess``, ``reenact.deca``, ``reenact.shift``,
  ``reenact.synthesis`` and ``reenact.outputs``; every kernel of a call
  on one device falls in exactly one of them. Inside ``reenact.synthesis``
  a StyleGAN3 generator opens one ``sg3.layer`` a layer
  (``models/stylegan3.py``: ``index``, ``rate``, ``size``, ``channels``);
* :func:`counters`: the kernels' counters (launches, K3's argument builds,
  the launch plans K3 and K4 made, K4's channels-last launches and planes
  prefetched) by dotted name;
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

import torch
from torch._C._profiler import _RecordFunctionFast


def span(name: str, **args):
    """``with span("reenact.deca"): ...``: while a ``torch.profiler``
    session is active, a labelled range in its trace (a CPU event that is
    the correlation parent of every kernel launched inside it, nested in
    the spans open around it on this thread); ``args`` (numbers) are
    recorded with it when the profiler records shapes. With no session,
    or while ``torch.export`` / ``torch.compile`` trace the code, a
    ``nullcontext``: one C call, no CUDA event, no sync, no allocation,
    and nothing in an exported graph.

    ``_RecordFunctionFast`` is ``record_function``'s C form; unlike
    ``record_function``, whose string argument the trace drops, it keeps
    ``args`` as the event's keyword inputs. The spans stay in the
    profiler's memory: whoever exports the trace writes them."""
    if not torch.autograd._profiler_enabled() or torch.compiler.is_compiling():
        return contextlib.nullcontext()
    return _RecordFunctionFast(name, (), args)


def counters() -> Dict[str, int]:
    """Every counter the port's kernels keep, by ``<function>.<counter>``:
    each operator's launches (``fused_conv_block_cuda.launches`` and the
    rest), K3's argument builds (``fused_conv_block.args_built``: a
    ConvBlock's folds and packed weights made anew), the launch plans K3 and
    K4 made anew (``fused_conv_block_cuda.plan_misses``,
    ``filtered_lrelu_cuda.plan_misses``), K4's launches on a channels-last
    batch (``filtered_lrelu_cuda.nhwc_launches``, beside ``launches``) and
    its ``filtered_lrelu_cuda.prefetched_planes`` (planes whose input a
    block had in flight before it needed them). They count from the
    process's start."""
    from ..ops import filtered_lrelu, fused_act, fused_conv_block, upfirdn2d_kernel
    fns = (upfirdn2d_kernel.upfirdn2d_cuda, upfirdn2d_kernel.upfirdn2d_bwd_cuda,
           fused_act.fused_bias_act_cuda, fused_act.fused_bias_act_bwd_cuda,
           fused_conv_block.fused_conv_block_cuda, fused_conv_block.fused_conv_block_bwd,
           fused_conv_block.fused_conv_block, filtered_lrelu.filtered_lrelu_cuda)
    return {f"{f.__name__}.{k}": v for f in fns for k, v in sorted(vars(f).items())
            if type(v) is int}


@contextlib.contextmanager
def trace(logdir: str = "reenact_trace"):
    """Capture a trace: ``with trace('out/t'): step()`` writes
    ``out/t/trace.json`` (shapes and the spans' arguments recorded) and
    ``out/t/counters.json`` (each of :func:`counters`' change over the
    block); the context yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = counters()
    with profile(activities=activities, record_shapes=True) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    after = counters()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "counters.json"), "w") as f:
        json.dump({k: v - before.get(k, 0) for k, v in after.items()}, f, indent=2)


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
