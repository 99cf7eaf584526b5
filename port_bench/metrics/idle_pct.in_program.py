"""The device's idle share of the traced window while the program runs: 100
× the time in which no kernel or copy runs on the device and a
``reenact.call`` span (one call of the entry) is open on the host, over the
traced window. ``idle_pct.reenact`` less this share is the idle time while
the benchmark's loop issues uploads, awaits and downloads. Both are read in
one traced run, under one profiler, and both are inflated by the profiler's
host cost (the host enqueues slower, so the device waits longer); the
device's busy seconds are what the profiler leaves nearly as they are.
None where the program records no such span."""

from typing import List, Tuple

SPAN = "reenact.call"


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted unions of intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    tr = run.readings["trace"]
    lo, hi = tr.win
    calls = _union([(max(s, lo), min(e, hi)) for s, e, name, _ in tr.cpu
                    if name == SPAN and e > lo and s < hi])
    if not calls:
        return None
    inside = sum(e - s for s, e in calls)
    return 100.0 * (inside - _overlap(calls, tr.busy())) / (hi - lo)
