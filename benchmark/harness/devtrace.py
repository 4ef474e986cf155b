"""The device trace of the traced requests, from torch.profiler (CUPTI),
reduced to intervals on the host clock: busy time as the union of the
device operations' intervals, kernel time as their sum, and the idle gaps
between them."""

from __future__ import annotations

import contextlib
import time


def union_seconds(intervals, t0: float = None, t1: float = None) -> float:
    """Length of the union of [start, end) intervals, clipped to [t0, t1]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if t0 is not None:
            s = max(s, t0)
        if t1 is not None:
            e = min(e, t1)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, t0: float, t1: float):
    """[(start, end)] of the stretches of [t0, t1] that no interval covers."""
    out, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(s, e) for s, e in out if e > s]


def is_kernel(name: str) -> bool:
    """Copies and fills are device operations but not kernels."""
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


class DeviceTrace:
    """Profile a block of work on the card; afterwards `ops` holds
    (name, start, end) of every device operation, in seconds on the host's
    perf_counter clock. The clocks are aligned by a marker: after a
    synchronise the host reads its clock and launches one short kernel, the
    first device operation of the trace."""

    def __init__(self):
        self.ops = []

    @contextlib.contextmanager
    def record(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t_host = time.perf_counter()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            yield self
            torch.cuda.synchronize()
        dev = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
               for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if not dev:
            return
        dev.sort(key=lambda x: x[1])
        offset = t_host - dev[0][1]
        self.ops = [(n, s + offset, e + offset) for n, s, e in dev[1:]]
