"""Shared arithmetic of the metric readers: a reader returns a number, or
None where its run holds nothing to read (the harness then leaves the
metric out of the line)."""

from __future__ import annotations

from harness.devtrace import is_kernel, union_seconds
from work.counts import least_seconds


def models_per_s(data):
    """All the models completed in the window over the time from its start
    to the last completion."""
    done = data.completed()
    if not done:
        return None
    return len(done) * data.models_per_request / (data.window[1] - data.window[0])


def span_ms(data, layer):
    """Mean milliseconds a completed request spent in `layer`'s spans; None
    where no wrapper of the layer saw a call."""
    spans = data.spans.spans
    if not any(s[0] == layer for s in spans):
        return None
    done = data.completed()
    total = sum(s[4] - s[3] for s in spans if s[0] == layer and any(s[2] == r[0] for r in done))
    return 1e3 * total / len(done)


def entry_self_ms(data):
    """Mean milliseconds of a request outside every span of the layers
    below the entry (prep, solve, init)."""
    done = data.completed()
    if not done or not data.spans.spans:
        return None
    inner = sum(union_seconds([(s[3], s[4]) for s in data.spans.of_request(r[0])])
                for r in done)
    return 1e3 * (sum(r[2] - r[1] for r in done) - inner) / len(done)


def anneal_ms(data):
    """Mean milliseconds of a request inside the solver's spans but outside
    its start functions: the step loop, the pick and the final terms."""
    done = data.completed()
    if not done or not any(s[0] == "solve" for s in data.spans.spans):
        return None
    total = 0.0
    for r in done:
        solve = [(s[3], s[4]) for s in data.spans.of_request(r[0], "solve")]
        total += union_seconds(solve) - _overlap(data.spans.of_request(r[0], "init"), solve)
    return 1e3 * total / len(done)


def _overlap(inits, solve):
    """Seconds of the init spans that lie inside the solve spans."""
    return sum(max(0.0, min(s[4], e) - max(s[3], b)) for s in inits for b, e in solve)


def traced_ops(data):
    if not data.traced or not data.ops:
        return None, None, None
    t0, t1 = data.traced[0][1], data.traced[-1][2]
    return [(n, s, e) for n, s, e in data.ops if e > t0 and s < t1], t0, t1


def kernels_roofline(data):
    """The least time of the traced requests' counted work over the summed
    time of every kernel in them, in %."""
    ops, _, _ = traced_ops(data)
    if not ops or data.peaks is None:
        return None
    kernel_s = sum(e - s for n, s, e in ops if is_kernel(n))
    if kernel_s <= 0:
        return None
    return 100.0 * len(data.traced) * least_seconds(*data.work, data.peaks) / kernel_s


def device_idle_pct(data):
    """The share of the traced window in which no device operation runs."""
    ops, t0, t1 = traced_ops(data)
    if not ops:
        return None
    return 100.0 * (1.0 - union_seconds([(s, e) for _, s, e in ops], t0, t1) / (t1 - t0))
