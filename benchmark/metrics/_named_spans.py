"""Milliseconds a traced request spends inside the program's spans of one
name (chromosome3d_tpu_torch/utils/trace.py), for the readers of single
spans."""

from __future__ import annotations

from metrics._program import _per_request, _requests, merged, program_records


def named_span_ms(data, name: str, recs=None):
    """The mean over the traced requests of the milliseconds inside the
    union of a request's spans called `name`; None where no traced request
    holds one (a program that does not record that span)."""
    recs = program_records() if recs is None else recs
    if not recs or not data.traced:
        return None
    if not any(r.name == name for _, mine in _requests(data, recs) for r in mine):
        return None
    return _per_request(data, recs, lambda roots, mine: 1e3 * sum(
        e - s for s, e in merged((r.t0, r.t1) for r in mine if r.name == name)))
