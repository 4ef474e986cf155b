"""Readers of the program's own spans and counters
(chromosome3d_tpu_torch/utils/trace.py), recorded while the traced run's
profiler records. A root span (`request`) belongs to the harness request
whose [start, end] holds its t0; a request's spans are those under the
request ids of its roots. Each reader is a mean over the traced requests,
and None where the program holds no such record (a program without
utils/trace.py, or a run with no profiler)."""

from __future__ import annotations

from harness.devtrace import idle_gaps


def program_records():
    """The program's span records, or None where it keeps none."""
    try:
        from chromosome3d_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.records() or None


def _requests(data, recs):
    """[(the traced request's roots, the records under their request ids)]."""
    roots = [r for r in recs if r.name == "request"]
    out = []
    for _, ts, te, _ in data.traced:
        mine = [r for r in roots if ts <= r.t0 <= te]
        ids = {r.request for r in mine}
        out.append((mine, [r for r in recs if r.request in ids]))
    return out


def _per_request(data, recs, value):
    """The mean over the traced requests of value(roots, records); None
    where no traced request holds a root."""
    recs = program_records() if recs is None else recs
    if not recs or not data.traced:
        return None
    reqs = _requests(data, recs)
    if not any(roots for roots, _ in reqs):
        return None
    return sum(value(roots, mine) for roots, mine in reqs) / len(reqs)


def merged(intervals):
    """Sorted, disjoint [start, end] intervals covering the given ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_gaps(data):
    """The device's idle stretches over the traced requests' window, or
    None without a device trace."""
    if not data.traced or not data.ops:
        return None
    t0, t1 = data.traced[0][1], data.traced[-1][2]
    ops = [(s, e) for _, s, e in data.ops if e > t0 and s < t1]
    if not ops:
        return None
    return merged(idle_gaps(ops, t0, t1))


def transfer_ms(data, recs=None):
    """Milliseconds a request in the program's uploads and downloads
    (xfer.h2d + xfer.d2h; the waits before them are not counted)."""
    return _per_request(data, recs, lambda roots, mine: 1e3 * sum(
        r.t1 - r.t0 for r in mine if r.name in ("xfer.h2d", "xfer.d2h")))


def copies(data, recs=None):
    """The program's uploads and downloads a request, from the xfer.h2d and
    xfer.d2h records: {"h2d", "h2d_bytes", "d2h", "d2h_bytes"}, each a mean
    over the traced requests; None where no traced request holds a root."""
    def total(name, field):
        return lambda roots, mine: float(sum(
            r.attrs["bytes"] if field else 1 for r in mine if r.name == name))

    out = {}
    for kind in ("h2d", "d2h"):
        out[kind] = _per_request(data, recs, total("xfer." + kind, False))
        out[kind + "_bytes"] = _per_request(data, recs, total("xfer." + kind, True))
    return None if out["h2d"] is None else out


def idle_ms(data, prefix: str, recs=None):
    """Device-idle milliseconds a request inside the union of its spans
    whose names start with `prefix` ("init.", "solve.")."""
    gaps = device_gaps(data)
    if gaps is None:
        return None
    return _per_request(data, recs, lambda roots, mine: 1e3 * overlap(
        gaps, merged((r.t0, r.t1) for r in mine if r.name.startswith(prefix))))


def host_launches(data, recs=None):
    """Kernel launches a request: the roots' deltas of the kernel wrappers'
    launch counters, summed."""
    return _per_request(data, recs, lambda roots, mine: float(sum(
        sum(r.attrs["launches"].values()) for r in roots)))


def idle_by_span(data, recs=None):
    """{innermost program span's name: device-idle seconds} over the traced
    requests; idle inside a root but outside every span below it counts
    under "request", idle outside every root under "outside". None without
    a device trace or program records."""
    recs = program_records() if recs is None else recs
    gaps = device_gaps(data)
    if not recs or gaps is None:
        return None
    mine = sorted((r for _, rs in _requests(data, recs) for r in rs), key=lambda r: r.t0)
    out, active, k = {}, [], 0
    for s, e in gaps:
        while k < len(mine) and mine[k].t0 < e:
            active.append(mine[k])
            k += 1
        active = [r for r in active if r.t1 > s]
        cuts = sorted({s, e} | {t for r in active for t in (r.t0, r.t1) if s < t < e})
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            inner = [r for r in active if r.t0 <= mid <= r.t1]
            name = min(inner, key=lambda r: r.t1 - r.t0).name if inner else "outside"
            out[name] = out.get(name, 0.0) + (b - a)
    return out
