"""Tests of the port's benchmark. Run from the repository root:

  python -m pytest port_bench/tests -q                # on the CPU
  python -m pytest port_bench/tests -q -m cuda        # the card tests, on a card
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


@pytest.fixture
def card():
    """The CUDA card; the test skips without one (decided here, never at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
