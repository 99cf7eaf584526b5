"""The traced window: ``torch.profiler`` events read in memory (no trace
file), reduced to the device's busy intervals, the kernels launched under
each registered operator, the longest idle gaps and the costliest device
operations. The window is the span of the ``port_bench.window`` label."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "port_bench.window"


def category(kernel_name: str) -> str:
    """A device kernel's class (the port's smoke script's grouping)."""
    n = kernel_name.lower()
    if "fcb_" in n:
        return "K3 fused conv block"
    if "upfirdn2d_kernel" in n:
        return "K1 upfirdn2d"
    if "bias_act_bwd" in n:
        return "K2-bwd fused bias-act backward"
    if "bias_act" in n:
        return "K2 fused bias-act"
    if any(s in n for s in ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad",
                            "fft", "winograd", "mult_and_sum_complex")):
        return "convolution (cuDNN)"
    if any(s in n for s in ("gemm", "cutlass", "sm90_", "matmul", "nvjet")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    if any(s in n for s in ("elementwise", "vectorized", "reduce", "copy", "fill")):
        return "elementwise/reduce/copy"
    return "other"


class Trace:
    """What one profiled call left: device intervals (ns), CPU op events."""

    def __init__(self, prof):
        self._prof = prof
        self._fevents = None
        self.device: List[Tuple[int, int, str, int]] = []   # start, end, name, linked op id
        cpu: List[Tuple[int, int, str, int]] = []
        win = None
        events = list(prof.profiler.kineto_results.events())
        host_names = {k.name() for k in events
                      if k.device_type() == torch.autograd.DeviceType.CPU}
        for k in events:
            dt = k.device_type()
            start, dur = k.start_ns(), k.duration_ns()
            if dt == torch.autograd.DeviceType.CUDA:
                if k.name() in host_names:
                    continue          # the GPU side of a host annotation: no work
                self.device.append((start, start + dur, k.name(), k.linked_correlation_id()))
            elif dt == torch.autograd.DeviceType.CPU:
                if k.name() == WINDOW and win is None:
                    win = (start, start + dur)
                cpu.append((start, start + dur, k.name(), k.start_thread_id()))
        if win is None:
            raise RuntimeError("the traced window's label is missing from the profile")
        self.win = win
        self.cpu = sorted(cpu)

    @property
    def fevents(self) -> Dict[int, object]:
        """The CPU operations by correlation id (built on first use: slow
        on long traces)."""
        if self._fevents is None:
            self._fevents = {e.id: e for e in self._prof.events()
                             if e.device_type == torch.autograd.DeviceType.CPU}
        return self._fevents

    @property
    def window_s(self) -> float:
        return (self.win[1] - self.win[0]) * 1e-9

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device's kernel and memory intervals in the window."""
        lo, hi = self.win
        spans = sorted((max(s, lo), min(e, hi)) for s, e, *_ in self.device if e > lo and s < hi)
        out: List[Tuple[int, int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-9

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest idle gaps, each named by the host operations
        (outermost / innermost) running where it starts."""
        lo, hi = self.win
        edges, prev = [], lo
        for s, e in self.busy():
            if s > prev:
                edges.append((prev, s))
            prev = e
        if hi > prev:
            edges.append((prev, hi))
        edges.sort(key=lambda g: g[0] - g[1])
        starts = [c[0] for c in self.cpu]
        out = []
        for s, e in edges[:n]:
            i = bisect.bisect_right(starts, s)
            open_ops = [c for c in self.cpu[max(0, i - 4000):i]
                        if c[1] >= s and c[2] != WINDOW]
            if open_ops:
                name = f"{open_ops[0][2]} / {open_ops[-1][2]}"
            else:
                name = "no host operation"
            out.append([name[:160], (e - s) * 1e-9])
        return out

    def device_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device operations with the most time in the window,
        by raw name under their class."""
        lo, hi = self.win
        tot: Dict[str, int] = defaultdict(int)
        for s, e, name, _ in self.device:
            if e > lo and s < hi:
                tot[name] += min(e, hi) - max(s, lo)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[f"{category(k)}: {k}"[:200], v * 1e-9] for k, v in top]

    def under_op(self, op: str) -> List[Tuple[object, float]]:
        """Each call of operator ``op`` in the window (the event of that name
        that recorded its input shapes) and the device seconds of the
        kernels launched inside it."""
        secs: Dict[int, float] = defaultdict(float)
        for s, e, _, corr in self.device:
            ev = self.fevents.get(corr)
            top = None
            while ev is not None:
                if ev.name == op and (top is None or ev.input_shapes):
                    top = ev
                ev = ev.cpu_parent
            if top is not None:
                secs[top.id] += (e - s) * 1e-9
        return [(self.fevents[i], t) for i, t in secs.items()]


def op_summary(trace: Trace, op: str) -> str:
    calls = trace.under_op(op)
    shaped = sum(1 for ev, _ in calls if ev.input_shapes)
    return (f"{op}: {len(calls)} calls, {shaped} with input shapes, "
            f"{sum(t for _, t in calls) * 1e3:.3f} device ms")


def traced(fn: Callable[[], object], record_shapes: bool = True) -> Tuple[Trace, object]:
    """Run ``fn`` under the profiler, its work synchronized inside the
    window label; return the reduced trace and ``fn``'s value."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        with record_function(WINDOW):
            value = fn()
            torch.cuda.synchronize()
    return Trace(prof), value


def cuda_ms(fn: Callable[[], object], reps: int = 3) -> float:
    """The median of ``reps`` device times of ``fn`` by CUDA events (ms)."""
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]
