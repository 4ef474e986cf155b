"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
repository root (CPU), and `python -m pytest benchmark/tests -q -m cuda` on
a machine with the card. Tests marked `cuda` decide inside the `card`
fixture whether there is one, and skip without."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
