"""A served request past L_pad = 8192, the route of hg19 chr1 at 10 kb
(24,925 beads -> 25,088) through `serve.SolverCache.solve`, on the CPU at a
small size: the length buckets and the chunked terms' gate are patched down,
so a 600-bead request pads past the buckets to 608, is prepped on the device
and takes the row-chunked final terms in two blocks of 304 rows.

The returned assessment view and energies are held against the benchmark's
plain reference (benchmark/reference: the restraints worked out again in
float64, the energy at the returned coordinates) with the check's own
comparison and the limits of the `chr1_10kb_run` cell. Under a profiler the
`prep.tiles` and `prep.view` spans carry the prep's route (one-shot, or
streamed where should_stream_prep is patched true), `prep.view` its source
(the solve's one-shot tiles copied, or the streamed view prepped again),
and the `solve.terms` span its row blocks; without one nothing is recorded. The routes at the
cell's full size are computed from the port's functions for an H100 80GB.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chromosome3d_tpu_torch import serve
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu_torch.ops import device_prep
from chromosome3d_tpu_torch.ops.energy import chunked_row_blocks
from chromosome3d_tpu_torch.solver import anneal
from chromosome3d_tpu_torch.utils import trace

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness.check import Judge  # noqa: E402
from reference.truth import confined_walk, if_matrix  # noqa: E402

L, L_PAD, ROW_CHUNK = 600, 608, 304
SEED = 23
# torch's total_memory of an NVIDIA H100 80GB HBM3 (79.18 GiB)
H100_BYTES = 85_017_493_504
with open(os.path.join(BENCH, "workloads", "chr1_10kb_run.json")) as f:
    LIMITS = json.load(f)["check"]


def _cfg():
    an = dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), landmark_count=16)
    return PipelineConfig(model_count=2, length_buckets=(64,), shard_quantum=32, seed=SEED,
                          restraints=RestraintConfig(alpha=0.5), anneal=an)


@pytest.fixture(scope="module")
def matrix():
    return if_matrix(confined_walk(L, seed=SEED), 0.5, 0.1, SEED + 1)


def _solve(matrix, recording: bool, monkeypatch=None, streamed: bool = False):
    """(coords, energies, dense view, the records) of one served request."""
    mp = monkeypatch or pytest.MonkeyPatch()
    mp.setattr(anneal, "CHUNKED_TERMS_MIN_L", 512)
    if streamed:
        mp.setattr(device_prep, "should_stream_prep", lambda *a, **k: True)
        mp.setattr(device_prep, "_pick_strip_rows", lambda L_pad, cap=4096: 152)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.clear()
    try:
        cache = serve.SolverCache(_cfg(), device="cpu")
        assert cache.bucket_for(L) == L_PAD
        if recording:
            with profile(activities=[ProfilerActivity.CPU]):
                out = cache.solve(matrix, _cfg())
        else:
            out = cache.solve(matrix, _cfg())
        return out[0], out[1], out[3], trace.records()
    finally:
        torch.set_num_threads(n)
        if monkeypatch is None:
            mp.undo()


@pytest.fixture(scope="module")
def one_shot(matrix):
    return _solve(matrix, recording=True)


def _judge(matrix, coords, energies, view):
    """The check's numbers of one request, as benchmark/harness/check.py
    reads them."""
    an = _cfg().anneal
    judge = Judge(dataclasses.asdict(an), 0.5, 2, "cpu")
    judge.restraints(0, matrix, view.target, view.w)
    judge.models_of(0, matrix, coords, energies["overall"])
    assert not judge.missing
    return judge.numbers()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_a_one_shot_request_matches_the_reference_and_records_its_route(matrix, one_shot):
    coords, energies, view, recs = one_shot
    assert coords.shape == (2, L, 3) and view.target.shape == (L, L)
    nums = _judge(matrix, coords, energies, view)
    assert nums["restraint_mismatch"] <= LIMITS["restraint_mismatch"], nums
    assert nums["energy_gap"] <= LIMITS["energy_gap"], nums
    names = _by_name(recs)
    # the solve's prep, whose float32 tiles are the view: its copy's launch
    # and join, and the copy's downloads, one a tile (600 rows, one block)
    assert len(names["prep.tiles"]) == 1 and len(names["prep.view"]) == 2
    route = {"route": "one_shot", "est_bytes": device_prep.prep_peak_bytes(L_PAD), "strips": 0}
    assert names["prep.tiles"][0].attrs == route
    for r in names["prep.view"]:
        assert r.attrs == {**route, "source": "solve_tiles"}, r
    assert [r.attrs["bytes"] for r in names["xfer.d2h"]] == [L * L * 4] * 2
    (terms,) = names["solve.terms"]
    assert terms.attrs == {"chunked": True, "blocks": L_PAD // ROW_CHUNK}
    (final,) = names["solve.final"]
    assert terms.parent == final.id and final.t0 <= terms.t0 <= terms.t1 <= final.t1


def test_a_streamed_request_matches_the_reference_and_records_its_strips(matrix, monkeypatch):
    coords, energies, view, recs = _solve(matrix, recording=True, monkeypatch=monkeypatch,
                                          streamed=True)
    nums = _judge(matrix, coords, energies, view)
    assert nums["restraint_mismatch"] <= LIMITS["restraint_mismatch"], nums
    assert nums["energy_gap"] <= LIMITS["energy_gap"], nums
    names = _by_name(recs)
    assert len(names["prep.tiles"]) == 1 and len(names["prep.view"]) == 1
    # 600 real rows in strips of 152: four strips a sweep
    route = {"route": "streamed", "est_bytes": device_prep.prep_peak_bytes(L_PAD), "strips": 4}
    assert names["prep.tiles"][0].attrs == route
    # the streamed tiles are not the view's: it is prepped again
    assert names["prep.view"][0].attrs == {**route, "source": "re_prep"}
    assert [r.attrs for r in names["solve.terms"]] == [{"chunked": True, "blocks": 2}]


def test_nothing_is_recorded_without_a_profiler_and_the_results_are_bit_equal(matrix, one_shot):
    coords, energies, view, recs = _solve(matrix, recording=False)
    assert recs == []
    np.testing.assert_array_equal(coords, one_shot[0])
    for k in energies:
        np.testing.assert_array_equal(energies[k], one_shot[1][k])
    np.testing.assert_array_equal(view.target, one_shot[2].target)
    np.testing.assert_array_equal(view.w, one_shot[2].w)


def test_the_whole_matrix_terms_record_no_blocks(matrix):
    """Below the gate the final terms are the whole-matrix form."""
    cfg = _cfg()
    cache = serve.SolverCache(cfg, device="cpu")
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        cache.solve(matrix[:100, :100], cfg)
    rec = _by_name(trace.records())["solve.terms"]
    assert [r.attrs for r in rec] == [{"chunked": False, "blocks": 0}]


@pytest.mark.parametrize("beads,L_pad,route,strips", [
    (4985, 5120, "one_shot", 0),        # hg19 chr1 at 50 kb
    (24925, 25088, "one_shot", 0),      # hg19 chr1 at 10 kb
    (25601, 26112, "streamed", 8),      # the first length that streams
])
def test_the_route_at_full_size_on_an_h100(monkeypatch, beads, L_pad, route, strips):
    """SolverCache's bucket and the prep's route a served request takes on
    an H100 80GB (torch's 79.18 GiB), computed from the port's functions:
    chr1 at 10 kb sits under a quarter of the card, 25,601 beads do not."""
    monkeypatch.setattr(device_prep, "_memory_bytes", lambda dev: H100_BYTES)
    assert serve.SolverCache(PipelineConfig(), device="cpu").bucket_for(beads) == L_pad
    got = device_prep.prep_route(L_pad, beads, "cpu")
    assert got == {"route": route, "est_bytes": 32 * L_pad * L_pad, "strips": strips}
    assert chunked_row_blocks(L_pad) == L_pad // 512
