"""The `chr1_10kb_run` cell and the readers of single program spans
(metrics/_named_spans.py: view_ms, terms_ms): the readers on hand-made
records, in the style of test_bench_program.py, and the cell's own path at a
size the CPU holds, past the buckets and on the row-chunked final terms
(the chunked terms' gate patched down, as tests/test_torch_serve_past_8192.py
patches it), judged against the cell's limits. A sound run is correct, the
control is not."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from harness.main import RunData
from harness.spans import SpanLog
from metrics import terms_ms, view_ms
from metrics._named_spans import named_span_ms

SEQ = iter(range(1, 10_000))


def _rec(name, t0, t1, request, **attrs):
    return SimpleNamespace(name=name, t0=t0, t1=t1, id=next(SEQ), parent=None,
                           request=request, attrs=attrs)


def _data(traced):
    return RunData(records=traced, setup_s=1.0, window=(traced[0][1], traced[-1][2]),
                   models_per_request=10, spans=SpanLog(lambda: None), traced=traced,
                   ops=[], work=(1.0, 1.0), peaks=None, peak_window_bytes=0)


# two traced requests, one root each; a warm-up root outside both is ignored
TRACED = [(0, 10.0, 11.0, True), (1, 11.0, 12.0, True)]
ONE_SHOT = {"route": "one_shot", "est_bytes": 20141047808, "strips": 0}
RECS = [
    _rec("request", 10.1, 10.9, 1, launches={}),
    _rec("prep.tiles", 10.1, 10.2, 1, **ONE_SHOT),
    _rec("solve.terms", 10.5, 10.6, 1, chunked=True, blocks=49),
    _rec("prep.view", 10.6, 10.9, 1, **ONE_SHOT),
    _rec("prep.tiles", 10.6, 10.7, 1, **ONE_SHOT),
    _rec("request", 11.1, 11.9, 2, launches={}),
    _rec("solve.terms", 11.5, 11.7, 2, chunked=True, blocks=49),
    _rec("prep.view", 11.7, 11.8, 2, **ONE_SHOT),
    _rec("request", 5.0, 6.0, 3, launches={}),
    _rec("prep.view", 5.0, 6.0, 3, **ONE_SHOT),
    _rec("solve.terms", 5.0, 6.0, 3, chunked=True, blocks=49),
]


def test_view_and_terms_ms_are_means_over_the_traced_requests(monkeypatch):
    d = _data(TRACED)
    assert named_span_ms(d, "prep.view", RECS) == pytest.approx(200.0)
    assert named_span_ms(d, "solve.terms", RECS) == pytest.approx(150.0)
    # the readers take the program's own records
    from metrics import _named_spans

    monkeypatch.setattr(_named_spans, "program_records", lambda: RECS)
    assert view_ms.read(d) == pytest.approx(200.0)
    assert terms_ms.read(d) == pytest.approx(150.0)


def test_spans_of_one_name_that_nest_count_once():
    recs = RECS + [_rec("solve.terms", 10.52, 10.58, 1, chunked=True, blocks=49)]
    assert named_span_ms(_data(TRACED), "solve.terms", recs) == pytest.approx(150.0)


def test_a_request_without_the_span_reads_zero_and_a_program_without_it_none():
    # request 1 has no view: (300 + 0) / 2
    recs = [r for r in RECS if not (r.name == "prep.view" and r.request == 2)]
    assert named_span_ms(_data(TRACED), "prep.view", recs) == pytest.approx(150.0)
    # a program that records roots but no solve.terms (one before the span):
    # the metric is left out of the line, not read as 0
    older = [r for r in RECS if r.name != "solve.terms" or r.request == 3]
    assert named_span_ms(_data(TRACED), "solve.terms", older) is None
    assert named_span_ms(_data(TRACED), "solve.terms", []) is None


def test_readers_return_none_without_program_records(monkeypatch):
    import sys

    import chromosome3d_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "chromosome3d_tpu_torch.utils.trace", None)
    monkeypatch.delattr(utils, "trace", raising=False)
    assert view_ms.read(_data(TRACED)) is None
    assert terms_ms.read(_data(TRACED)) is None


@pytest.fixture(scope="module")
def small_10kb():
    """chr1_10kb_run at 600 beads: past 64-bead buckets to 608, the prep on
    the device and the final terms in two row blocks."""
    from bench_small import small_cell
    from chromosome3d_tpu_torch.solver import anneal

    mp = pytest.MonkeyPatch()
    mp.setattr(anneal, "CHUNKED_TERMS_MIN_L", 512)
    yield small_cell("chr1_10kb_run", [600], {"length_buckets": [64], "shard_quantum": 32})
    mp.undo()


def test_sound_small_run_is_correct(small_10kb):
    from bench_small import run_small

    r = run_small(small_10kb)
    assert r["correct"], (r["check"], r["info"])
    assert r["failed"] == 0 and r["info"]["checked_models"] > 0


def test_control_small_run_is_not_correct(small_10kb):
    from bench_small import run_small

    r = run_small(small_10kb, control=True)
    assert not r["correct"], r["check"]
    assert r["check"]["energy_gap"]["value"] > r["check"]["energy_gap"]["limit"]


@pytest.mark.cuda
def test_a_short_run_of_the_cell_on_the_card_is_correct(card):
    """The cell at its full size (24,925 beads): the warm-up and one request."""
    import json
    import subprocess
    import sys

    from harness import spec

    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "chr1_10kb_run",
                        "--seed", "987654321987", "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, cwd=spec.ROOT, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["check"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
