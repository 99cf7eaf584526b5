"""The closed loop of one client, and the seeded sample of its answers.

One request is in flight at a time: the next is issued when the previous
one's outputs are in host memory. A request that ends after the window
closed is dropped from the metrics; the window's length is fixed."""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, List


class Reservoir:
    """A uniform sample of ``k`` of the requests completed, drawn from the
    seed while they complete (reservoir sampling)."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(seed * 8 + 7)
        self.k, self.n = k, 0
        self.items: List[Dict] = []

    def offer(self, make: Callable[[], Dict]) -> None:
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            r = self.rng.randrange(self.n + 1)
            if r < self.k:
                self.items[r] = make()
        self.n += 1


def closed_loop(step: Callable[[int], object], seconds: float, keep: Reservoir,
                record: Callable[[int, object], Dict]):
    """Run ``step(i)`` back to back for ``seconds``; each returns once its
    outputs are on the host. Returns (the completed requests' seconds,
    the window's seconds). ``record(i, outputs)`` copies what the sample
    keeps of request ``i``."""
    times: List[float] = []
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        t0 = time.perf_counter()
        out = step(i)
        t1 = time.perf_counter()
        if t1 - start <= seconds:
            times.append(t1 - t0)
            keep.offer(lambda: record(i, out))
        i += 1
    return times, seconds
