"""The work counts, the trace arithmetic and the metric readers on
hand-made shapes and intervals."""

from __future__ import annotations

import pytest

from harness.devtrace import idle_gaps, is_kernel, union_seconds
from harness.main import RunData, forbidden_modules
from harness.spans import SpanLog
from metrics import _common
from work.counts import (
    BEAD_UPDATE,
    PAIR_ENERGY,
    PAIR_GRAD,
    chromosome_work,
    least_seconds,
    request_work,
    structure_steps,
)

P = {"hot_steps": 2, "cool_cycles": 1, "cool_steps_per_cycle": 3, "final_steps": 1,
     "enantiomer": True}


def test_structure_steps():
    # 2 x 3 models through 2 hot steps, then 3 models through 4 steps
    assert structure_steps(P, 3) == 2 * 3 * 2 + 3 * 4


def test_chromosome_work_by_hand():
    ops, nbytes = chromosome_work(4, P, 3)
    pairs, ss = 6, 24
    assert ops == pairs * (ss * PAIR_GRAD + (6 + 3) * PAIR_ENERGY) + 4 * ss * BEAD_UPDATE
    assert nbytes == 16 * 8 + ss * 4 * 3 * 4 * 3 * 2
    assert request_work([4, 4], P, 3) == (2 * ops, 2 * nbytes)


def test_least_seconds_takes_the_larger_bound():
    peaks = {"fp32_flops": 10.0, "hbm_bytes_per_s": 2.0}
    assert least_seconds(100, 4, peaks) == 10.0
    assert least_seconds(10, 40, peaks) == 20.0


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert union_seconds(iv) == pytest.approx(3.0)
    assert union_seconds(iv, 1.5, 3.5) == pytest.approx(1.0)
    assert idle_gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert idle_gaps([], 0.0, 1.0) == [(0.0, 1.0)]
    assert is_kernel("void tri_pair_kernel<64>") and not is_kernel("Memcpy HtoD")


def _data(**kw):
    spans = SpanLog(lambda: None)
    spans.spans = kw.pop("spans", [])
    base = dict(records=[(0, 10.0, 11.0, True), (1, 11.0, 13.0, True)], setup_s=5.0,
                window=(10.0, 13.0), models_per_request=10, spans=spans, traced=[],
                ops=[], work=(67.0, 0.0), peaks={"fp32_flops": 67.0, "hbm_bytes_per_s": 1.0},
                peak_window_bytes=2**31)
    base.update(kw)
    return RunData(**base)


def test_rate_counts_every_model_over_the_window():
    assert _common.models_per_s(_data()) == pytest.approx(20 / 3.0)
    assert _common.models_per_s(_data(records=[(0, 10.0, 11.0, False)])) is None


def test_span_readers():
    spans = [("prep", "a", 0, 10.1, 10.3), ("solve", "s", 0, 10.3, 10.9),
             ("init", "i", 0, 10.3, 10.4), ("init", "j", 1, 11.0, 11.5)]
    d = _data(spans=spans)
    assert _common.span_ms(d, "prep") == pytest.approx(100.0)
    assert _common.span_ms(d, "init") == pytest.approx(300.0)
    assert _common.span_ms(d, "nothing") is None
    # request 0: 1.0 s less 0.8 s of spans; request 1: 2.0 s less 0.5 s
    assert _common.entry_self_ms(d) == pytest.approx(1e3 * (0.2 + 1.5) / 2)
    assert _common.anneal_ms(d) == pytest.approx(1e3 * 0.5 / 2)


def test_device_readers():
    ops = [("k1", 10.0, 10.4), ("Memcpy HtoD", 10.4, 10.5), ("k2", 10.8, 11.0)]
    d = _data(traced=[(0, 10.0, 11.0, True)], ops=ops)
    assert _common.device_idle_pct(d) == pytest.approx(100 * 0.3)
    # least time 1 s of work over 0.6 s of kernels (the copy is no kernel)
    assert _common.kernels_roofline(d) == pytest.approx(100 / 0.6)
    assert _common.kernels_roofline(_data()) is None


def test_no_jax_in_the_harness_process():
    assert forbidden_modules() == []
