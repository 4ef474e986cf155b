"""Spans and counters inside the port, and the torch.profiler trace of
`run --profile DIR` (profile_trace).

Spans record only while a torch profiler records in this thread
(`torch._C._autograd._profiler_enabled()`): under `run --profile DIR`, the
benchmark's traced requests, or an operator's own profiler. Otherwise
`span` and `request` return one shared null context, and `to_host` /
`to_device` are the plain `.cpu()` / `.to()`.

A span's record (Record) holds its name, t0 and t1 on time.perf_counter()
(the clock the benchmark maps the device's intervals onto), its id, its
parent's id, its request id and its attributes. Records go to an
in-memory list: `records()` reads it, `clear()` empties it. While
recording, each span is also a torch.profiler.record_function range, so
a `--profile` trace shows the spans over the kernels they launched.

The parent and the request travel in a context variable, so two threads
never share a request. A `request` span is a root: it allocates the
request id, unless a root is already open (then it opens nothing), and
keeps on its record (`launches`) the deltas of the launch counters of the
kernel wrappers that count_launches registered. A copy's record holds its
`bytes`. `spanned(name)` puts a whole function inside a span. The names in
use:

  request                 serve.SolverCache.solve, genome.solve_bucket,
                          genome.solve_bucket_sharded(_from_if),
                          pipeline.run_pipeline's solve
  prep.pad, prep.tiles    device_prep.pad_f32; device_prep.exact_tiles_from_if_device,
                          genome.bucket_tiles_from_if, pipeline._padded_dense
  prep.view               pipeline._assessment_view_from_if, pipeline's
                          view of the solve's tiles (two: the copy's launch
                          and its join, what the request waits for),
                          genome.bucket_views
                          (one-device: those of exact_tiles_from_if_device
                          and the two pipeline views carry
                          device_prep.prep_route's `route`, "one_shot" or
                          "streamed", `est_bytes`, the one-shot prep's
                          estimated device peak, and `strips`, the streamed
                          route's row strips a sweep, 0 one-shot; the
                          pipeline views also `source`, "solve_tiles" or
                          "re_prep")
  init.start              anneal.initial_structure (one a chromosome)
  init.landmark_sharded   sharded.sharded_landmark_init
  init.draws              anneal._draws (mirror pairs, jitter, noise seed;
                          the row-sharded landmark start inside it)
  solve.setup, solve.hot, solve.pick, solve.cool, solve.final
                          anneal._phases, the phases both backends share
                          (anneal._solve_stack, sharded._group_body)
  solve.terms             inside solve.final, one a chromosome: its final
                          energy terms, a fence before and at its end;
                          `chunked` (the row blocks of energy_terms_chunked,
                          or the sharded solver's rank strips) and `blocks`
                          (how many; 0 for the whole-matrix energy_terms)
  xfer.h2d                to_device: a host tensor's upload to a device
  xfer.wait, xfer.d2h     to_host: the wait for the device, then the
                          download (to_device waits in xfer.wait too);
                          add_copy: a download made off this thread (the
                          view of the solve's tiles), under the root

A traced wait is for the current stream of the device only: a copy on a
side stream runs on under it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import itertools
import os
import time
from typing import Optional

import numpy as np
import torch

_recording = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_RECORDS: list = []
_SPAN_IDS = itertools.count(1)
_REQUEST_IDS = itertools.count(1)
# (request id, id of the innermost open span, the root's Record)
_CURRENT = contextvars.ContextVar("chromosome3d_span", default=None)

# the kernel wrappers whose `.launches` a root reads (count_launches)
_COUNTED: list = []


@dataclasses.dataclass
class Record:
    name: str
    t0: float
    t1: Optional[float]
    id: int
    parent: Optional[int]
    request: Optional[int]
    attrs: dict


def records() -> list:
    """The records of every span closed since the last clear()."""
    return list(_RECORDS)


def clear() -> None:
    _RECORDS.clear()


def count_launches(fn):
    """Set a kernel wrapper's launch counter `fn.launches` to 0 (the
    wrapper adds 1 a launch), and have every request root keep its delta."""
    fn.launches = 0
    _COUNTED.append(fn)


def launch_counts() -> dict:
    """The registered kernel wrappers' `.launches` now, by function name."""
    return {fn.__name__: fn.launches for fn in _COUNTED}


class _Span:
    __slots__ = ("rec", "root", "nest", "token", "rf", "start")

    def __init__(self, name: str, attrs: dict, root: bool, nest: bool):
        cur = _CURRENT.get()
        if root:
            request, parent, self.root = next(_REQUEST_IDS), None, None
        elif cur is None:
            request, parent, self.root = None, None, None
        else:
            request, parent, self.root = cur
        self.rec = Record(name, 0.0, None, next(_SPAN_IDS), parent, request, attrs)
        self.nest = nest
        if root:
            self.root = self.rec
            self.start = launch_counts()

    def __enter__(self) -> Record:
        self.rf = torch.profiler.record_function(self.rec.name)
        self.rf.__enter__()
        if self.nest:
            self.token = _CURRENT.set((self.rec.request, self.rec.id, self.root))
        self.rec.t0 = time.perf_counter()
        return self.rec

    def __exit__(self, exc_type, exc, tb) -> bool:
        rec = self.rec
        rec.t1 = time.perf_counter()
        if self.nest:
            _CURRENT.reset(self.token)
        if self.root is rec:
            now = launch_counts()
            rec.attrs["launches"] = {k: v - self.start.get(k, 0) for k, v in now.items()}
        self.rf.__exit__(exc_type, exc, tb)
        _RECORDS.append(rec)
        return False


def span(name: str, nest: bool = True, **attrs):
    """A context manager: the block inside span `name` while a profiler
    records, the shared null context otherwise. nest=False: spans opened
    inside do not take it as their parent (a generator's block that stays
    open across yields, where other code runs between)."""
    if not _recording():
        return _NULL
    return _Span(name, attrs, root=False, nest=nest)


def request():
    """A context manager: the root `request` span of a solve, opened only
    where no root is open in this context and a profiler records."""
    if not _recording():
        return _NULL
    cur = _CURRENT.get()
    if cur is not None and cur[0] is not None:
        return _NULL
    return _Span("request", {}, root=True, nest=True)


def spanned(name: str):
    """A decorator: each call of the function inside span `name`, or inside
    a root where name is "request"; whether to record is asked at the call."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with request() if name == "request" else span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _wait(device) -> None:
    """Wait for the work queued on the current stream of a CUDA device."""
    torch.cuda.current_stream(device).synchronize()


def fence(device) -> None:
    """While recording, wait for a CUDA device's current stream, so that
    the span the call ends holds the device work launched inside it;
    otherwise nothing."""
    device = torch.device(device)
    if _recording() and device.type == "cuda":
        _wait(device)


def add_copy(t0: float, t1: float, nbytes: int) -> None:
    """While recording, an `xfer.d2h` record of `nbytes` downloaded from t0
    to t1 (time.perf_counter()) by another thread, which records nothing
    itself: the profiler records in the thread that started it. Its parent
    is the current request's root."""
    if not _recording():
        return
    cur = _CURRENT.get()
    request, root = (None, None) if cur is None else (cur[0], cur[2])
    _RECORDS.append(Record("xfer.d2h", t0, t1, next(_SPAN_IDS),
                           None if root is None else root.id, request, {"bytes": nbytes}))


def to_host(t: torch.Tensor) -> torch.Tensor:
    """t.cpu(). While recording, for a tensor on a device: first the wait
    for its current stream inside `xfer.wait`, then the copy inside `xfer.d2h` (the
    same synchronisation the copy makes anyway, so the values are the
    same). A host tensor is returned as it is, with no record."""
    if not _recording() or t.device.type == "cpu":
        return t.cpu()
    with span("xfer.wait"):
        if t.device.type == "cuda":
            _wait(t.device)
    with span("xfer.d2h", bytes=t.numel() * t.element_size()):
        return t.cpu()


def to_device(a, device) -> torch.Tensor:
    """A host array or tensor on `device` (a numpy array through
    torch.from_numpy, so it must be writable): a.to(device). While
    recording, a host tensor's upload is span `xfer.h2d`, after the wait
    for a CUDA device's current stream inside `xfer.wait`: a pageable upload's staging then
    no longer overlaps the kernels queued before it, though the blocking
    copy waits for its stream afterwards all the same, so the values are
    the same. A tensor already on a device, or bound for the host, is
    moved as given, with no record."""
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    if not _recording():
        return t.to(device)
    device = torch.device(device)
    if t.device.type != "cpu" or device.type == "cpu":
        return t.to(device)
    if device.type == "cuda":
        with span("xfer.wait"):
            _wait(device)
    with span("xfer.h2d", bytes=t.numel() * t.element_size()):
        return t.to(device)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace of the block (host activity, and the CUDA
    kernels and copies where there is a card), written into log_dir as a
    Chrome trace (`trace.json`: chrome://tracing, Perfetto), the spans
    above among its ranges; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
