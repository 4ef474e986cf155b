"""The check at a size the CPU holds: the harness's run (set-up, window,
check) with the look for a card skipped, each cell's path at small
lengths and the full protocol, against the cell's own limits. A sound run
is correct; the control and every planted fault are not."""

from __future__ import annotations

import pytest

from bench_faults import FAULTS, NOT_IN
from bench_small import run_small, small_cell

# lengths past the short chromosomes the protocol leaves unconverged, and
# buckets that put each cell's routes under them: the prep on the device
# past the buckets (chr1, the 100 kb genome's at-scale buckets) and host
# stacks of two chromosomes within them
SMALL = {
    "chr1_50kb_run": ([150], {"length_buckets": [64], "shard_quantum": 32}),
    "genome_45_bucket": ([150, 200], {"length_buckets": [256]}),
    "genome_100kb": ([100, 110, 150], {"length_buckets": [128], "shard_quantum": 32}),
}


@pytest.fixture(scope="module", params=sorted(SMALL))
def cell(request):
    return small_cell(request.param, *SMALL[request.param])


def test_sound_run_is_correct(cell):
    r = run_small(cell)
    assert r["correct"], (r["check"], r["info"])
    assert r["failed"] == 0 and r["info"]["checked_models"] > 0


def test_control_is_not_correct(cell):
    r = run_small(cell, control=True)
    assert not r["correct"], r["check"]
    assert r["check"]["energy_gap"]["value"] > r["check"]["energy_gap"]["limit"]


# every fault a cell can have (NOT_IN: the ones it cannot)
PAIRS = [(c, f) for c in sorted(SMALL) for f in sorted(FAULTS) if c not in NOT_IN.get(f, ())]


@pytest.mark.parametrize("cell,fault", PAIRS, indirect=["cell"])
def test_fault_is_not_correct(cell, fault):
    with FAULTS[fault]():
        r = run_small(cell)
    assert not r["correct"], (fault, r["check"], r["info"])
