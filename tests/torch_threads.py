"""torch's intra-op threads under pytest-xdist: an autouse module fixture
that gives each worker the cores over the workers (at least 1) while its
module runs, and all of them back after. Six workers on every core each
oversubscribe the machine: OpenMP's barriers then spin against each other
(the ArcFace and ResNet-50 backward passes slowed some 40-fold; the CPU
parity files that run whole pipelines 5-10-fold). Alone, a file keeps all
cores. A test file takes it by importing it:

    from torch_threads import _threads  # noqa: F401
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
