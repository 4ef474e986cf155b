"""The port's spans and counters (chromosome3d_tpu_torch/utils/trace.py) on
the CPU: nothing is recorded without a profiler and the results do not
change under one; each solve entry records one `request` root whose spans
are parented as the module's docstring lists them, under one request id;
a copy that stays on the host leaves no record; the root's launch deltas
are the registered kernel wrappers' counters; spans close on an
exception; two threads never share a request. The card tests (marked
`cuda`) check the copies' records of a genome run, and hold a span's clock
against the profiler's device intervals as benchmark/harness/devtrace.py
maps them: `python -m pytest tests/test_torch_trace.py --noconftest -q -m cuda`."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chromosome3d_tpu_torch import pipeline
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu_torch.io import write_if_matrix
from chromosome3d_tpu_torch.ops import (  # noqa: F401  (registers their wrappers' counters)
    fused_step,
    fused_update,
    general_pair,
    pair_energy,
    strip_tri,
    tri_energy,
)
from chromosome3d_tpu_torch.parallel import genome
from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure
from chromosome3d_tpu_torch.utils import trace

SEED = 11
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
SOLVE = ("solve.setup", "solve.hot", "solve.pick", "solve.cool", "solve.final")
# the names each span may have as its parent ("request": the root)
PARENTS = {
    "prep.pad": {"request", "prep.tiles"},
    "prep.tiles": {"request", "prep.view", "prep.tiles"},
    "prep.view": {"request"},
    "init.draws": {"request"},
    "init.start": {"request", "init.draws"},
    "init.landmark_sharded": {"init.draws"},
    **{name: {"request"} for name in SOLVE},
    **{name: {"request", "prep.tiles", "prep.view", "init.draws", "init.start",
              "init.landmark_sharded"} for name in ("xfer.h2d", "xfer.wait", "xfer.d2h")},
}


def _matrix(L, k):
    return if_from_structure(confined_walk(L, seed=k + 5), alpha=0.5, noise_sigma=0.1,
                             seed=k + 5)


def _cfg(**kw):
    an = dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), landmark_count=16)
    return PipelineConfig(model_count=2, length_buckets=(64,), shard_quantum=32, seed=SEED,
                          restraints=RestraintConfig(alpha=0.5), anneal=an, **kw)


def _bucket(tmp_path, lengths=(40, 52)):
    """A stacked bucket of 64 on the host and its config, as run_genome
    stacks it."""
    jobs = []
    for k, L in enumerate(lengths):
        path = str(tmp_path / f"chr{k + 1}_1mb.npy")
        np.save(path, _matrix(L, k))
        jobs.append(genome.GenomeJob(name=f"chr{k + 1}_1mb", path=path, length=L))
    batched, masks, _, raw = genome._stack_bucket(jobs, 64, _cfg())
    return batched, masks, pipeline.auto_exact(_cfg(), raw[0])


@pytest.fixture
def profiled():
    """A block under a CPU torch.profiler, the records cleared before."""
    trace.clear()
    return lambda: profile(activities=[ProfilerActivity.CPU])


def _tree(recs):
    """(the one root, {span name: [records]}), each span's parent by name
    checked against PARENTS, every record under the root's request id."""
    roots = [r for r in recs if r.name == "request"]
    assert len(roots) == 1, [r.name for r in roots]
    root = roots[0]
    by_id = {r.id: r for r in recs}
    names = {}
    for r in recs:
        assert r.request == root.request, r
        assert r.t0 <= r.t1
        names.setdefault(r.name, []).append(r)
        if r is root:
            assert r.parent is None
            continue
        parent = by_id[r.parent]
        assert parent.name in PARENTS[r.name], (r.name, parent.name)
        assert parent.t0 <= r.t0 and r.t1 <= parent.t1
    return root, names


def _no_copies(names):
    """On the CPU every tensor is on the host: no copy is recorded."""
    assert not [n for n in names if n.startswith("xfer.")], sorted(names)


def test_nothing_is_recorded_without_a_profiler_and_the_results_are_bit_equal(profiled, tmp_path):
    """With no profiler a solve leaves no record; under one it records, and
    its coordinates, energies and history are bit for bit the same."""
    batched, masks, cfg = _bucket(tmp_path)
    plain = genome.solve_bucket(batched, masks, cfg, device="cpu")
    assert trace.records() == []
    with profiled():
        traced = genome.solve_bucket(batched, masks, cfg, device="cpu")
    assert trace.records()
    assert torch.equal(plain.coords, traced.coords)
    assert torch.equal(plain.history, traced.history)
    assert torch.equal(plain.pick, traced.pick)
    for k in plain.energies:
        assert torch.equal(plain.energies[k], traced.energies[k])
    # the shared null context and the plain copies while nothing records
    assert trace.span("solve.hot") is trace.request() is trace.span("x", nest=False)
    t = torch.arange(3.0)
    assert trace.to_host(t) is t and trace.to_device(t, "cpu") is t


def test_a_copy_that_stays_on_the_host_leaves_no_record(profiled):
    """Under a profiler, a host tensor's to_host and a host array's or
    tensor's to_device bound for the CPU are the plain copies, unrecorded."""
    t = torch.arange(3.0)
    with profiled():
        with trace.request():
            assert trace.to_host(t) is t and trace.to_device(t, "cpu") is t
            assert torch.equal(trace.to_device(np.arange(3.0, dtype=np.float32), "cpu"), t)
    assert [r.name for r in trace.records()] == ["request"]


def test_solve_bucket_records_one_request(profiled, tmp_path):
    """Two chromosomes through solve_bucket: one root holding a start and a
    draw a chromosome, and one of each solve phase (the copies' records:
    the card test below)."""
    batched, masks, cfg = _bucket(tmp_path)
    with profiled():
        genome.solve_bucket(batched, masks, cfg, device="cpu")
    root, names = _tree(trace.records())
    # a draw a chromosome, then solve_bucket_impl's check of the starts given
    assert len(names["init.start"]) == 2 and len(names["init.draws"]) == 4
    for name in SOLVE:
        assert len(names[name]) == 1, name
    _no_copies(names)


def test_solve_bucket_sharded_from_if_records_one_request(profiled):
    """An at-scale bucket from its IF matrices over four CPU shards, two
    chromosome groups of two ranks whose step loops run in lockstep: the
    prep (its uploads inside), a landmark start a chromosome inside its
    draws, each group body's phases under the root, one root."""
    cfg = _cfg()
    mats = [_matrix(L, k) for k, L in enumerate((70, 85))]
    with profiled():
        genome.solve_bucket_sharded_from_if(mats, 96, pipeline.auto_exact_matrix(cfg),
                                            devices=["cpu"] * 4, base_seed=SEED)
    root, names = _tree(trace.records())
    # the bucket's prep, and inside it each chromosome's in row strips
    prep = [r for r in names["prep.tiles"] if r.parent == root.id]
    assert len(prep) == 1 and len(names["prep.tiles"]) == 3
    assert len(names["init.landmark_sharded"]) == len(names["init.draws"]) == 2
    assert "init.start" not in names
    for name in SOLVE:
        assert len(names[name]) == 2, name
    # the two groups' hot loops are open at once
    a, b = names["solve.hot"]
    assert a.t0 < b.t1 and b.t0 < a.t1
    _no_copies(names)


def test_run_pipeline_records_one_request(profiled, tmp_path):
    """A small `run` on the CPU: one root around the solve, its prep, the
    start and the phases."""
    path = tmp_path / "chr9_1mb_matrix.txt"
    write_if_matrix(path, _matrix(40, 0))
    with profiled():
        pipeline.run_pipeline(str(path), str(tmp_path / "out"), _cfg(), device="cpu")
    root, names = _tree(trace.records())
    assert len(names["prep.tiles"]) == 1 and len(names["init.start"]) == 1
    for name in SOLVE:
        assert len(names[name]) == 1, name
    _no_copies(names)


def test_run_genome_gives_one_request_a_bucket(profiled, tmp_path):
    """run_genome calling solve_bucket: the bucket's solve of its two
    chromosomes is one root, and on the CPU every record is under it."""
    recs = _genome_run(tmp_path, profiled, "cpu")
    root, names = _tree(recs)
    assert len(names["init.start"]) == 2
    _no_copies(names)


def _genome_run(tmp_path, profiled, device):
    """The records of run_genome over two chromosomes (40 and 52 beads) on
    `device`."""
    d = tmp_path / "in"
    d.mkdir()
    for k, L in enumerate((40, 52)):
        write_if_matrix(d / f"chr{k + 1}_1mb_matrix.txt", _matrix(L, k))
    with profiled():
        genome.run_genome(str(d), str(tmp_path / "out"), _cfg(), device=device)
    return trace.records()


def _count_twin_calls(monkeypatch):
    """Each kernel wrapper's plain twin, where the CPU runs it, counts one
    launch on the wrapper, as the card's launch would."""
    twins = {"fused_steps_batched": "fused_steps_plain",
             "fused_update_table": "fused_update_plain"}
    for wrapper in trace._COUNTED:
        mod = sys.modules[wrapper.__module__]
        name = twins.get(wrapper.__name__, wrapper.__name__ + "_plain")
        real = getattr(mod, name)

        def twin(*args, _real=real, _wrapper=wrapper, **kwargs):
            _wrapper.launches += 1
            return _real(*args, **kwargs)

        twin.calls = getattr(real, "calls", 0)   # the twins count themselves by name
        monkeypatch.setattr(mod, name, twin)


@pytest.mark.parametrize("route", ["fused", "strip"])
def test_root_launch_deltas_are_the_wrappers_counters(route, profiled, monkeypatch,
                                                     tmp_path):
    """The root's `launches` are the wrappers' counters over the request:
    the fused route's B1 twice and the B2 pick; the strip route's B6 a step
    and for the pick, B4 a step."""
    _count_twin_calls(monkeypatch)
    cfg = _cfg()
    before = trace.launch_counts()
    with profiled():
        if route == "fused":
            batched, masks, cfg = _bucket(tmp_path)
            genome.solve_bucket(batched, masks, cfg, device="cpu")
        else:
            genome.solve_bucket_sharded_from_if([_matrix(70, 0)], 96,
                                                pipeline.auto_exact_matrix(cfg),
                                                devices=["cpu"], base_seed=SEED)
    after = trace.launch_counts()
    root, _ = _tree(trace.records())
    assert root.attrs["launches"] == {k: after[k] - before[k] for k in before}
    T = cfg.anneal.total_steps
    want = ({"fused_steps_batched": 2, "exact_pair_energy_grad": 1} if route == "fused"
            else {"strip_tri_energy_grad": T + 1, "fused_update_table": T})
    assert {k: v for k, v in root.attrs["launches"].items() if v} == want


def test_a_registered_wrapper_joins_the_roots_launches(profiled, monkeypatch):
    """count_launches sets a wrapper's counter to 0 and puts it in every
    root's deltas, a wrapper registered while the root is open too."""
    monkeypatch.setattr(trace, "_COUNTED", list(trace._COUNTED))

    def kernel():
        kernel.launches += 1

    with profiled():
        with trace.request():
            trace.count_launches(kernel)
            assert kernel.launches == 0
            kernel()
            kernel()
    root, = trace.records()
    assert root.attrs["launches"]["kernel"] == 2
    assert set(root.attrs["launches"]) == {fn.__name__ for fn in trace._COUNTED}


def test_spans_close_on_an_exception(profiled, tmp_path):
    """A span and its root close when the block raises; the next request
    is a root of its own."""
    with profiled():
        with pytest.raises(ValueError):
            with trace.request():
                with trace.span("solve.hot"):
                    raise ValueError("boom")
        batched, masks, cfg = _bucket(tmp_path)
        with pytest.raises(ValueError, match="model_shards"):
            genome.solve_bucket(batched, masks, cfg, device="cpu", model_shards=3)
        with trace.request():
            pass
    recs = trace.records()
    assert [r.name for r in recs] == ["solve.hot", "request", "request", "request"]
    assert all(r.t1 is not None for r in recs)
    assert recs[0].parent == recs[1].id and recs[0].request == recs[1].request
    assert len({r.request for r in recs[1:]}) == 3


def test_two_threads_get_two_requests(monkeypatch):
    """Each thread's spans join its own request, with both open at once."""
    monkeypatch.setattr(trace, "_recording", lambda: True)
    trace.clear()
    barrier = threading.Barrier(2)

    def client():
        with trace.request():
            barrier.wait()
            with trace.span("solve.hot"):
                barrier.wait()
                with trace.span("xfer.d2h"):
                    pass

    threads = [threading.Thread(target=client) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = trace.records()
    roots = {r.id: r for r in recs if r.name == "request"}
    assert len(roots) == 2 and len({r.request for r in roots.values()}) == 2
    hot = {r.id: r for r in recs if r.name == "solve.hot"}
    for r in recs:
        if r.name == "solve.hot":
            assert r.parent in roots and roots[r.parent].request == r.request
        elif r.name == "xfer.d2h":
            assert r.parent in hot and hot[r.parent].request == r.request
    for root in roots.values():
        assert sum(r.request == root.request for r in recs) == 3


def test_many_threads_keep_their_requests_apart(monkeypatch):
    """Sixteen threads, each a request of fifty spans with a span inside
    each, the interpreter switching threads every microsecond: every record
    is kept, ids are unique, and each span lands in its own thread's
    request."""
    monkeypatch.setattr(trace, "_recording", lambda: True)
    trace.clear()
    n, k = 16, 50

    def client():
        with trace.request():
            for _ in range(k):
                with trace.span("solve.hot"):
                    with trace.span("xfer.d2h"):
                        pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    recs = trace.records()
    assert len(recs) == n * (1 + 2 * k)
    assert len({r.id for r in recs}) == len(recs)
    roots = {r.request: r for r in recs if r.name == "request"}
    assert len(roots) == n
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name != "request":
            assert by_id[r.parent].request == r.request
    assert all(sum(r.request == q for r in recs) == 1 + 2 * k for q in roots)


@pytest.mark.cuda
def test_copies_on_the_card_are_recorded_where_they_happen(profiled, tmp_path):
    """run_genome over two chromosomes on the card: the bucket's uploads
    (the tiles' target and w, the masks), the starts' copies around the
    host eigh and the jitter under the one root, parented as PARENTS lists;
    a wait before each download; the coordinates' and energies' downloads
    after the solve outside any request."""
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    recs = _genome_run(tmp_path, profiled, "cuda")
    roots = [r for r in recs if r.name == "request"]
    assert len(roots) == 1
    root, names = _tree([r for r in recs if r.request == roots[0].request])
    assert {"xfer.h2d", "xfer.wait", "xfer.d2h"} <= set(names)
    ups = [r.attrs["bytes"] for r in names["xfer.h2d"] if r.parent == root.id]
    assert ups[:3] == [2 * 64 * 64 * 4, 2 * 64 * 64 * 4, 2 * 64 * 4]
    assert all(r.attrs["bytes"] > 0 for n in ("xfer.h2d", "xfer.d2h") for r in names[n])
    assert len(names["xfer.d2h"]) == len(names["xfer.wait"]) - len(names["xfer.h2d"])
    outside = [r for r in recs if r.request is None]
    assert {r.name for r in outside} == {"xfer.wait", "xfer.d2h"}
    # the coordinates of both chromosomes' two models at L_pad, first
    d2h = [r for r in outside if r.name == "xfer.d2h"]
    assert d2h[0].attrs["bytes"] == 2 * 2 * 64 * 3 * 4


@pytest.mark.cuda
def test_cli_run_profile_on_the_card_names_the_copies(monkeypatch, capsys, tmp_path):
    """`run --profile DIR --device cuda --fast -m 2` on a small matrix (the
    length bucket cut to 64 beads) writes DIR/trace.json, whose ranges name
    the solve's phases, the uploads and the coordinates' download."""
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    from chromosome3d_tpu_torch import cli

    path = tmp_path / "chr7_1mb_matrix.txt"
    write_if_matrix(path, _matrix(40, 0))
    make = cli._make_config
    monkeypatch.setattr(cli, "_make_config",
                        lambda args: make(args).replace(length_buckets=(64,)))
    prof = tmp_path / "prof"
    argv = ["run", "-i", str(path), "-o", str(tmp_path / "out"), "--device", "cuda",
            "--fast", "-m", "2", "--profile", str(prof)]
    assert cli.main(argv) == 0
    capsys.readouterr()
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    for name in ("request", "solve.hot", "solve.pick", "solve.cool", "solve.final",
                 "xfer.h2d", "xfer.wait", "xfer.d2h"):
        assert name in names, name


# a fresh process, as a benchmark run is: a span around each of two
# synchronised torch.cuda._sleep launches under DeviceTrace, the sleep kernel
# loaded first where argv[2] is "warm"; prints [[span t0, t1], [sleep start,
# end]] on the host clock
_PROBE = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from harness.devtrace import DeviceTrace
from chromosome3d_tpu_torch.utils import trace
torch.zeros(1, device="cuda")
if sys.argv[2] == "warm":
    torch.cuda._sleep(1000)
torch.cuda.synchronize()
dt = DeviceTrace()
with dt.record():
    for cycles in (2_000_000, 20_000_000):
        with trace.span("probe"):
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
print(json.dumps([[(r.t0, r.t1) for r in trace.records() if r.name == "probe"],
                  [(s, e) for n, s, e in dt.ops if "spin_kernel" in n]]))
"""


def _probe(marker: str):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    out = subprocess.run([sys.executable, "-c", _PROBE, BENCH, marker], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _held(spans, sleeps):
    """Each span holds its sleep to within 0.1 ms."""
    assert len(spans) == 2 and len(sleeps) == 2, (spans, sleeps)
    for (t0, t1), (s, e) in zip(spans, sleeps):
        assert t0 - 1e-4 <= s and e <= t1 + 1e-4, (t0, t1, s, e)


@pytest.mark.cuda
def test_a_span_holds_its_kernel_on_the_device_clock():
    """A span around a synchronised torch.cuda._sleep holds that kernel's
    interval as the benchmark's DeviceTrace maps it onto the host clock,
    to within 0.1 ms: the program's spans and the device intervals share
    one clock. The sleep kernel is loaded before the trace starts: its
    first launch in a process loads the module on the host first, which
    would delay DeviceTrace's marker (the same kernel) past the clock
    reading it is aligned to (the next test). In a process of its own, so
    no profiler of an earlier test is in the way."""
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    _held(*_probe("warm"))


@pytest.mark.cuda
@pytest.mark.xfail(strict=True, raises=AssertionError, reason=(
    "DeviceTrace's marker is a process's first torch.cuda._sleep, whose module loads "
    "after the host reads its clock: in a fresh process, as in benchmark/run.py, the "
    "device maps about 1.6 ms early (NVIDIA H100 80GB HBM3: a span began 1.55 ms after "
    "its sleep's mapped start). Passes once the marker is launched before the clock "
    "is read."))
def test_a_span_holds_its_kernel_with_a_cold_marker():
    """The test above where nothing launched torch.cuda._sleep before
    DeviceTrace starts, as in a benchmark run."""
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    _held(*_probe("cold"))
