"""The readers of the program's own spans and counters
(metrics/_program.py, and transfer_ms, init_idle_ms, solve_idle_ms,
host_launches; the copies idle_split.py prints) on hand-made records and device intervals."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from harness.main import RunData
from harness.spans import SpanLog
from metrics import _program

SEQ = iter(range(1, 10_000))


def _rec(name, t0, t1, request, parent=None, **attrs):
    return SimpleNamespace(name=name, t0=t0, t1=t1, id=next(SEQ), parent=parent,
                           request=request, attrs=attrs)


def _data(traced, ops=()):
    return RunData(records=traced, setup_s=1.0, window=(traced[0][1], traced[-1][2]),
                   models_per_request=10, spans=SpanLog(lambda: None), traced=traced,
                   ops=list(ops), work=(1.0, 1.0), peaks=None, peak_window_bytes=0)


# two traced requests: the first holds two roots (two buckets), the second
# one; a root outside both (a warm-up) and spans of no request are ignored
TRACED = [(0, 10.0, 11.0, True), (1, 11.0, 12.0, True)]
L1 = {"fused_steps_batched": 2, "exact_pair_energy_grad": 1, "tri_energy_grad": 0}
L2 = {"strip_tri_energy_grad": 11, "fused_update_table": 10}
RECS = [
    _rec("request", 10.1, 10.5, 1, launches=L1),
    _rec("xfer.h2d", 10.1, 10.12, 1, bytes=8),
    _rec("xfer.wait", 10.12, 10.2, 1),
    _rec("init.start", 10.2, 10.3, 1),
    _rec("solve.hot", 10.3, 10.45, 1),
    _rec("xfer.d2h", 10.45, 10.5, 1, bytes=8),
    _rec("request", 10.6, 10.9, 2, launches=L2),
    _rec("init.landmark_sharded", 10.6, 10.7, 2),
    _rec("solve.cool", 10.7, 10.9, 2),
    _rec("request", 11.1, 11.9, 3, launches=L1),
    _rec("init.draws", 11.1, 11.5, 3),
    _rec("init.start", 11.2, 11.4, 3),
    _rec("solve.hot", 11.5, 11.9, 3),
    _rec("xfer.d2h", 11.9, 11.95, None, bytes=8),
    _rec("request", 5.0, 6.0, 4, launches=L2),
    _rec("xfer.h2d", 5.0, 6.0, 4, bytes=8),
]
# the device busy everywhere but [10.25, 10.35], [10.8, 10.85], [11.3, 11.6]
OPS = [("k", 10.0, 10.25), ("k", 10.35, 10.8), ("k", 10.85, 11.3), ("k", 11.6, 12.0)]


def test_interval_arithmetic():
    assert _program.merged([(3, 4), (0, 1), (0.5, 2)]) == [[0, 2], [3, 4]]
    assert _program.overlap([[0, 2], [3, 4]], [[1, 3.5]]) == pytest.approx(1.5)
    assert _program.overlap([], [[0, 1]]) == 0.0
    assert _program.device_gaps(_data(TRACED, OPS)) == [[10.25, 10.35], [10.8, 10.85],
                                                       [11.3, 11.6]]
    assert _program.device_gaps(_data(TRACED)) is None


def test_transfer_ms_sums_the_copies_not_the_waits():
    # request 0: 20 + 50 ms; request 1: none of its own (the download after
    # its root belongs to no request)
    assert _program.transfer_ms(_data(TRACED), RECS) == pytest.approx(35.0)


def test_copies_count_and_sum_the_bytes_a_request():
    # request 0: one upload and one download of 8 bytes; request 1: none
    assert _program.copies(_data(TRACED), RECS) == pytest.approx(
        {"h2d": 0.5, "h2d_bytes": 4.0, "d2h": 0.5, "d2h_bytes": 4.0})
    assert _program.copies(_data(TRACED), []) is None


def test_idle_inside_init_and_solve_spans():
    d = _data(TRACED, OPS)
    # init: request 0 [10.25, 10.3] of init.start and [10.6, 10.7] none;
    # request 1 [11.3, 11.5] inside the draws' union -> (50 + 200) / 2
    assert _program.idle_ms(d, "init.", RECS) == pytest.approx(125.0)
    # solve: request 0 [10.3, 10.35] + [10.8, 10.85]; request 1 [11.5, 11.6]
    assert _program.idle_ms(d, "solve.", RECS) == pytest.approx(100.0)
    assert _program.idle_ms(_data(TRACED), "solve.", RECS) is None


def test_host_launches_sum_the_roots_deltas():
    # request 0: 3 + 21 launches; request 1: 3
    assert _program.host_launches(_data(TRACED), RECS) == pytest.approx(13.5)


def test_idle_by_span_names_the_innermost_span():
    by = _program.idle_by_span(_data(TRACED, OPS), RECS)
    assert by == pytest.approx({"init.start": 0.15, "solve.hot": 0.15, "solve.cool": 0.05,
                                "init.draws": 0.1})
    # a gap under no span below a root, and one under no root
    extra = RECS + [_rec("request", 12.0, 12.5, 5, launches={})]
    d = _data(TRACED + [(2, 12.0, 13.0, True)], OPS + [("k", 12.6, 13.0)])
    by = _program.idle_by_span(d, extra)
    assert by["request"] == pytest.approx(0.5) and by["outside"] == pytest.approx(0.1)


def test_readers_return_none_without_program_records(monkeypatch):
    d = _data(TRACED, OPS)
    assert _program.transfer_ms(d, []) is None
    # no root inside any traced request
    outside = [r for r in RECS if r.request == 4]
    assert _program.host_launches(d, outside) is None
    assert _program.idle_ms(d, "init.", outside) is None
    # a program without utils/trace.py
    import sys

    import chromosome3d_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "chromosome3d_tpu_torch.utils.trace", None)
    monkeypatch.delattr(utils, "trace", raising=False)
    assert _program.program_records() is None
    assert _program.transfer_ms(d) is None


def test_an_untraced_run_leaves_no_program_record():
    """A `--trace 0` run (the harness's window with no profiler) leaves the
    program's record list empty: the spans cost one check each."""
    from bench_small import run_small, small_cell
    from chromosome3d_tpu_torch.utils import trace

    trace.clear()
    r = run_small(small_cell("chr1_50kb_run", [150], {"length_buckets": [64],
                                                      "shard_quantum": 32}))
    assert r["correct"] and r["attempted"] >= 1
    assert trace.records() == []
