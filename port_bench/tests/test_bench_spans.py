"""The readers of the program's own spans: on the CPU, each on a stub trace
whose answer is known; on the card, one traced chunk of each cell, whose
stage spans have to account for their call's device time, and whose call
has to hold all of the window's device work but the loop's copies to and
from host memory (in ``ffhq1024.crops`` the loop's pageable ``.cpu()`` of
the outputs, 3-8 % of the busy time as the host's memory allows) and a few
µs of kernels that the trace links to no operation of the call."""

import importlib
from types import SimpleNamespace

import pytest

from harness import cell, common

SEED = 2**31 + 4242
CELLS = [w["name"] for w in common.benchmark()["workloads"]]
STAGES = ("reenact.inputs", "reenact.preprocess", "reenact.deca", "reenact.shift",
          "reenact.synthesis", "reenact.outputs")
SPAN_METRICS = ("preprocess_ms.span", "deca_ms.span", "synthesis_ms.span", "idle_pct.in_program")


class StubTrace:
    """A window of 0-1000 ns; busy intervals and host events as given; the
    device seconds under each span as given."""

    def __init__(self, busy, cpu, under=None):
        self.win, self._busy, self.cpu, self._under = (0, 1000), busy, cpu, under or {}

    def busy(self):
        return self._busy

    def under_op(self, op):
        return [(None, t) for t in self._under.get(op, [])]


def _outside(trace, span):
    """The device operations of the window launched under no ``span``: (name,
    seconds)."""
    lo, hi = trace.win
    out = []
    for s, e, name, corr in trace.device:
        if e > lo and s < hi:
            ev = trace.fevents.get(corr)
            while ev is not None and ev.name != span:
                ev = ev.cpu_parent
            if ev is None:
                out.append((name, (min(e, hi) - max(s, lo)) * 1e-9))
    return out


def _read(name, trace):
    return cell.read_metric(name, SimpleNamespace(readings={"trace": trace}))


def test_idle_in_program_on_a_stub_trace():
    busy = [(0, 100), (150, 400), (600, 700)]
    cpu = [(-10, 20, "reenact.call", 1),        # clipped to the window: all busy
           (50, 500, "reenact.call", 1),        # busy 50 + 250 of 450: 150 idle
           (100, 200, "reenact.call", 2),       # inside the one above (another thread)
           (60, 70, "aten::mm", 1),
           (520, 640, "port_bench.window", 1),
           (650, 900, "reenact.call", 1)]       # busy 50 of 250: 200 idle
    assert _read("idle_pct.in_program", StubTrace(busy, cpu)) == pytest.approx(35.0)
    assert _read("idle_pct.in_program", StubTrace(busy, [(0, 1000, "aten::mm", 1)])) is None


@pytest.mark.parametrize("name", ["preprocess_ms.span", "deca_ms.span", "synthesis_ms.span"])
def test_stage_ms_on_a_stub_trace(name):
    span = "reenact." + name.split("_ms")[0]
    tr = StubTrace([], [], {span: [0.012, 0.010, 0.0115, 0.011]})
    assert _read(name, tr) == pytest.approx(11.25)
    assert _read(name, StubTrace([], [])) is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_stage_spans_account_for_the_call(card, name):
    w = common.cell(name)
    tr = dict(common.traffic(w["traffic"]), trace_chunks=1)
    run = cell.Run(w, common.config(w["config"]), tr, SEED, card)
    ent = cell.entry(tr)
    ent.setup(run)
    counters = importlib.import_module(f"{common.PORT}.utils.profiling").counters
    before = counters()
    ent.traced(run)
    built = {k: v - before[k] for k, v in counters().items() if v != before[k]}
    trace = run.readings["trace"]
    ms = {s: 1e3 * sum(t for _, t in trace.under_op(s)) for s in ("reenact.call",) + STAGES}
    stages = sum(ms[s] for s in STAGES)
    busy = 1e3 * trace.busy_s()
    outside = _outside(trace, "reenact.call")
    got = {m["name"]: cell.read_metric(m["name"], run) for m in cell.per_layer_names(name)
           if m["name"] in SPAN_METRICS}
    ent.release(run)
    print(name, ms, f"busy {busy:.3f} ms, {len(trace.cpu)} host events", got, built,
          trace.idle_gaps(), outside)
    assert abs(stages - ms["reenact.call"]) <= 0.01 * ms["reenact.call"], ms
    copies = 1e3 * sum(t for n, t in outside if n.startswith("Memcpy"))
    stray = 1e3 * sum(t for n, t in outside if not n.startswith("Memcpy"))
    assert stray <= 0.001 * busy, outside
    assert ms["reenact.call"] + copies + stray == pytest.approx(busy, rel=0.01), (ms, copies, busy)
    assert all(v is not None for v in got.values()), got
