"""The port's warm-model server (chromosome3d_tpu_torch.serve) on the CPU:
each case of tests/test_serve.py against the port, over a real Unix socket
with the server on a thread; a served matrix request byte-equal to
run_pipeline on the same matrix and config (within the buckets and past
them); the same requests answered alike by the JAX package's handle_request
and the port's (ok flags, the bounds' error strings, the warm buckets); and
`serve` / `submit` through the port's CLI, the client importing no torch.

Small sizes: L 10-48, 2 models, the fast schedule, on device="cpu" (the
kernels' plain twins)."""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from chromosome3d_tpu import pipeline as jax_pipeline
from chromosome3d_tpu import serve as jax_serve
from chromosome3d_tpu.config import AnnealConfig as JaxAnnealConfig
from chromosome3d_tpu.config import PipelineConfig as JaxPipelineConfig
from chromosome3d_tpu.config import fast_anneal as jax_fast_anneal
from chromosome3d_tpu_torch import cli
from chromosome3d_tpu_torch import pipeline as port_pipeline
from chromosome3d_tpu_torch import serve as srv
from chromosome3d_tpu_torch.config import (
    AnnealConfig,
    PipelineConfig,
    RestraintConfig,
    fast_anneal,
    turbo_anneal,
)
from chromosome3d_tpu_torch.io import write_if_matrix
from chromosome3d_tpu_torch.serve import MAX_QUEUE, SolverCache, handle_request, request, serve
from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(model_count=2, length_buckets=(64, 128, 256, 512))
# past the buckets at small L: 40 beads pad to quantum_bucket(40, 16) = 48
PAST = dict(model_count=2, length_buckets=(16, 24), shard_large=True, shard_quantum=16)


def _port_cfg(**kw):
    return PipelineConfig(anneal=fast_anneal(AnnealConfig()), **{**BASE, **kw})


def _write_matrix(path, L, seed):
    X = confined_walk(L, seed=seed)
    write_if_matrix(path, if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=seed))
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Matrices of 35 and 37 beads (the 64 bucket), 20 and 22 (the 24
    bucket), 40 (past the buckets of PAST), and a 10-bead `.rr` chain."""
    d = tmp_path_factory.mktemp("serve_inputs")
    paths = {L: _write_matrix(d / f"chr{L}_matrix.txt", L, seed=L) for L in (20, 22, 35, 37, 40)}
    rr = d / "chain.rr"
    rr.write_text("".join(f"{i} {i + 1} 3.8 3.8 1.0\n" for i in range(1, 10)))
    paths["rr"] = str(rr)
    return paths


def _start(sock, cfg, device="cpu"):
    t = threading.Thread(target=serve, args=(sock, cfg, device), daemon=True)
    t.start()
    for _ in range(200):
        if os.path.exists(sock):
            break
        time.sleep(0.05)
    return t


@pytest.fixture()
def server():
    # a short socket path: a Unix socket path is at most 108 bytes
    d = tempfile.mkdtemp(prefix="c3d")
    sock = os.path.join(d, "s.sock")
    t = _start(sock, _port_cfg())
    yield sock
    try:
        request(sock, {"cmd": "shutdown"}, timeout=5)
    except OSError:
        pass
    t.join(timeout=10)
    shutil.rmtree(d, ignore_errors=True)


def test_ping(server):
    resp = request(server, {"cmd": "ping"})
    assert resp["ok"] and resp["pong"]
    assert resp["warm_buckets"] == [] and resp["busy"] == 0


def test_solve_request_and_warm_reuse(server, inputs, tmp_path):
    """Two matrices of one bucket: both solve, the second on the warm
    bucket (one warm entry). The JAX test also asserts the second request
    is faster (its first compiles); on the CPU the port builds nothing, so
    that has no counterpart here (chip_smoke.py prints both walls)."""
    resp = request(server, {"matrix": inputs[35], "out": str(tmp_path / "o1"), "models": 2})
    assert resp["ok"], resp
    assert resp["summary"]["L"] == 35
    assert (tmp_path / "o1" / "chr35_matrix_model1.pdb").exists()
    resp2 = request(server, {"matrix": inputs[37], "out": str(tmp_path / "o2"), "models": 2})
    assert resp2["ok"] and resp2["summary"]["L"] == 37
    pong = request(server, {"cmd": "ping"})
    assert pong["warm_buckets"] == [[64, 2, fast_anneal(AnnealConfig()).total_steps]]


def test_bad_request_keeps_serving(server):
    resp = request(server, {"matrix": "/nonexistent.txt", "out": "/tmp/x"})
    assert not resp["ok"] and "error" in resp
    assert request(server, {"cmd": "ping"})["ok"]


def test_shutdown():
    """shutdown answers, ends the serving thread and removes the socket."""
    d = tempfile.mkdtemp(prefix="c3d")
    sock = os.path.join(d, "s.sock")
    t = _start(sock, _port_cfg())
    try:
        resp = request(sock, {"cmd": "shutdown"})
        assert resp["ok"] and resp["bye"]
        t.join(timeout=10)
        assert not t.is_alive() and not os.path.exists(sock)
    finally:
        shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("kind", ["tbl", "rr"])
def test_restraint_file_requests(server, tmp_path, kind):
    """The general distance-geometry request: a CNS tbl (with an or-group
    row) or a CONFOLD-style .rr, solved through the warm server."""
    if kind == "tbl":
        lines = [f"assign45 (resid {i:3d} and name ca) (resid {i + 1:3d} and name ca)"
                 f"  3.80 0.00 0.00" for i in range(1, 12)]
        lines.append("assign ((resid 1 and name ca) or (resid 2 and name ca)) "
                     "(resid 9 and name ca) 5.00 0.00 0.00")
        path = tmp_path / "amb.tbl"
    else:
        lines = [f"{i} {i + 1} 3.8 3.8 1.0" for i in range(1, 10)]
        path = tmp_path / "chain.rr"
    path.write_text("\n".join(lines) + "\n")
    out = tmp_path / "out_r"
    resp = request(server, {"restraints": str(path), "out": str(out), "models": 2})
    assert resp["ok"], resp
    if kind == "tbl":
        assert resp["summary"]["or_groups"] == 1 and resp["summary"]["restraints"] == 11
    else:
        assert resp["summary"]["restraints"] == 9 and resp["summary"]["or_groups"] == 0
    assert (out / f"{path.stem}_model1.pdb").exists()


def test_ping_during_a_slow_solve(server, inputs, tmp_path, monkeypatch):
    """Control requests answer while a solve holds the device: a ping during
    a long solve (or a first request's kernel build, which runs under the
    same lock) returns at once with busy >= 1."""
    real = SolverCache.solve

    def slow_solve(self, matrix, cfg):
        time.sleep(2.0)
        return real(self, matrix, cfg)

    monkeypatch.setattr(SolverCache, "solve", slow_solve)
    result = {}

    def bg():
        result["resp"] = request(server, {"matrix": inputs[35], "models": 2,
                                          "out": str(tmp_path / "slow_out")})

    t = threading.Thread(target=bg, daemon=True)
    t.start()
    pong, deadline = None, time.time() + 1.9
    while time.time() < deadline:
        t0 = time.time()
        pong = request(server, {"cmd": "ping"}, timeout=5)
        dt = time.time() - t0
        assert pong["ok"] and pong["pong"]
        assert dt < 1.0, f"ping took {dt:.2f}s during a solve"
        if pong["busy"] >= 1:
            break
        time.sleep(0.05)
    assert pong and pong["busy"] >= 1
    t.join(timeout=600)
    assert not t.is_alive() and result["resp"]["ok"], result


def _bound_cases(src, out):
    return [
        ({"matrix": src, "out": out, "models": 10**6}, "models"),
        ({"matrix": src, "out": out, "models": 0}, "models"),
        ({"matrix": src, "out": out, "alpha": -1.0}, "alpha"),
        ({"matrix": src, "out": out, "kscaling": 0}, "kscaling"),
        ({"restraints": "/nonexistent.tbl", "out": out}, "restraints"),
        ({"matrix": src}, "out"),
        ({"out": out}, "matrix"),
        ({"cmd": "frobnicate"}, "unknown cmd"),
        ({"matrix": src, "out": out, "models": "many"}, "malformed"),
        ({"matrix": src, "out": out, "L": 1}, "L=1 out of bounds"),
        ({"matrix": src, "out": "  "}, "non-empty"),
    ]


def test_request_bounds(server, inputs, tmp_path):
    """Out-of-bounds or malformed requests are answered ok=false and the
    server keeps serving."""
    for req, frag in _bound_cases(inputs[35], str(tmp_path / "x")):
        resp = request(server, req, timeout=30)
        assert not resp["ok"], (req, resp)
        assert frag in resp["error"], (req, resp)
    assert request(server, {"cmd": "ping"})["ok"]


def test_restraint_file_oversized_L_rejected(server, tmp_path):
    """A restraint file naming a residue beyond MAX_L is refused before any
    tensor is allocated or a solve is queued, and the server still solves."""
    big = srv.MAX_L + 1000
    tbl = tmp_path / "huge.tbl"
    tbl.write_text(f"assign45 (resid   1 and name ca) (resid {big} and name ca) "
                   "3.80 0.00 0.00\n")
    resp = request(server, {"restraints": str(tbl), "out": str(tmp_path / "o")})
    assert not resp["ok"] and "exceeds the cap" in resp["error"], resp
    rr = tmp_path / "huge.rr"
    rr.write_text(f"1 {big} 3.8 3.8 1.0\n")
    resp = request(server, {"restraints": str(rr), "out": str(tmp_path / "o2")})
    assert not resp["ok"] and "exceeds the cap" in resp["error"], resp
    assert request(server, {"cmd": "ping"})["ok"]
    small = tmp_path / "small.rr"
    small.write_text("\n".join(f"{i} {i + 1} 3.8 3.8 1.0" for i in range(1, 8)) + "\n")
    resp = request(server, {"restraints": str(small), "out": str(tmp_path / "o3"),
                            "models": 2})
    assert resp["ok"], resp


def test_beyond_bucket_single_device_uses_device_prep(monkeypatch, inputs):
    """Past the buckets (exact restraints) the prep runs on the device from
    the padded IF matrix (pad_f32, then exact_tiles_from_if_device), the
    host never builds restraints, and the host views, copied from the
    solve's own float32 tiles, equal the host route's."""
    from chromosome3d_tpu_torch import restraints as rst
    from chromosome3d_tpu_torch.io import load_if_matrix
    from chromosome3d_tpu_torch.ops import device_prep as dp

    cfg = PipelineConfig(anneal=fast_anneal(AnnealConfig()), **PAST)
    cache = SolverCache(cfg, device="cpu")
    calls, pads = [], []
    real, real_pad = dp.exact_tiles_from_if_device, dp.pad_f32

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    def pad_spy(a, L_pad):
        pads.append((a.shape, L_pad))
        return real_pad(a, L_pad)

    monkeypatch.setattr(dp, "exact_tiles_from_if_device", spy)
    monkeypatch.setattr(dp, "pad_f32", pad_spy)
    monkeypatch.setattr(rst, "build_restraints", lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("the at-scale matrix route must not build restraints on the host")))
    m = load_if_matrix(inputs[40])
    coords, energies, r, dense_view = cache.solve(m, cfg)
    # one prep, the solve's, at the quantum bucket on the cache's device,
    # from the one padded copy (the prep's own pad_f32 passes it through):
    # its float32 tiles are the assessment view
    assert [p for p in pads if p[0] != (48, 48)] == [((40, 40), 48)]
    assert len(calls) == 1 and all(a[1] == 48 for a, _ in calls)
    assert all(k["device"] == torch.device("cpu") and k["n_true"] == 40 for _, k in calls)
    assert coords.shape == (2, 40, 3) and np.isfinite(coords).all()
    assert cache.warm_snapshot() == [(48, 2, cfg.anneal.total_steps)]
    host = rst.dist_to_restraints(rst.if_to_dist(m, cfg.restraints), cfg.restraints)
    assert r.length == 40 and r.count == host.count
    np.testing.assert_array_equal(r.target, host.target)
    np.testing.assert_array_equal(r.mask, host.mask)
    np.testing.assert_array_equal(dense_view.target, host.target)


def _view_case(monkeypatch, case):
    """The PAST config and patches of one route past the buckets: the
    float32 one-shot tiles, pair_bf16's bf16 tiles, the streamed prep, or
    row strips over two CPU shards."""
    from chromosome3d_tpu_torch import device as device_mod
    from chromosome3d_tpu_torch.ops import device_prep as dp

    an = dataclasses.replace(fast_anneal(AnnealConfig()), pair_bf16=case == "pair_bf16")
    if case == "streamed":
        monkeypatch.setattr(dp, "should_stream_prep", lambda *a, **k: True)
        monkeypatch.setattr(dp, "_pick_strip_rows", lambda L_pad, cap=4096: 16)
    if case == "sharded":
        monkeypatch.setattr(device_mod, "shard_devices", lambda: [torch.device("cpu")] * 2)
        monkeypatch.setattr(port_pipeline, "_memory_bytes", lambda dev: 0)
    return PipelineConfig(anneal=an, **PAST)


@pytest.mark.parametrize("case,preps,source", [
    ("float32", 1, "solve_tiles"),
    ("pair_bf16", 2, "re_prep"),
    ("streamed", 1, "re_prep"),
    ("sharded", 2, "re_prep"),
])
def test_beyond_bucket_view_is_the_re_prepped_view(monkeypatch, inputs, case, preps, source):
    """Past the buckets the served view is bit for bit the view prepped
    again after the solve (_assessment_view_from_if): copied from the
    solve's tiles where they are one device's float32 one-shot tiles, and
    re-prepped after the solve where they are bf16, streamed or row strips
    (the solve's prep and the view's: two calls of the one-shot prep, one
    on the streamed route). Each `prep.view` span carries its source."""
    from torch.profiler import ProfilerActivity, profile

    from chromosome3d_tpu_torch.io import load_if_matrix
    from chromosome3d_tpu_torch.ops import device_prep as dp
    from chromosome3d_tpu_torch.utils import trace

    cfg = _view_case(monkeypatch, case)
    calls = []
    real = dp.exact_tiles_from_if_device
    monkeypatch.setattr(dp, "exact_tiles_from_if_device",
                        lambda *a, **k: calls.append(k.get("out_dtype")) or real(*a, **k))
    m = load_if_matrix(inputs[40])
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        coords, _, r, view = SolverCache(cfg, device="cpu").solve(m, cfg)
    assert len(calls) == preps, calls
    views = [rec for rec in trace.records() if rec.name == "prep.view"]
    assert views and {rec.attrs["source"] for rec in views} == {source}
    assert len(views) == (2 if source == "solve_tiles" else 1)
    r_want, want = port_pipeline._assessment_view_from_if(
        dp.pad_f32(m, 48), cfg.restraints, 48, 40, "cpu")
    for got, ref in ((view.target, want.target), (view.w, want.w), (r.target, r_want.target),
                     (r.mask, r_want.mask)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    if source == "solve_tiles":
        assert view.target.flags.c_contiguous and view.w.flags.c_contiguous
    assert coords.shape == (2, 40, 3) and np.isfinite(coords).all()


def test_the_view_of_the_solve_tiles_owns_its_memory(monkeypatch, inputs):
    """The view copied from the solve's float32 tiles shares no memory with
    them (on the CPU the tiles are host memory too), and the tiles are let
    go once the request returns."""
    import weakref

    from chromosome3d_tpu_torch.io import load_if_matrix
    from chromosome3d_tpu_torch.ops import device_prep as dp

    cfg = _port_cfg(**PAST)
    tiles = []
    real = dp.exact_tiles_from_if_device

    def spy(*a, **k):
        out = real(*a, **k)
        tiles.append((out.target.numpy(), out.w.numpy(), weakref.ref(out.target)))
        return out

    monkeypatch.setattr(dp, "exact_tiles_from_if_device", spy)
    _, _, r, view = SolverCache(cfg, device="cpu").solve(load_if_matrix(inputs[40]), cfg)
    ((target, w, ref),) = tiles
    for a in (view.target, view.w, r.target):
        assert not np.shares_memory(a, target) and not np.shares_memory(a, w)
    np.testing.assert_array_equal(view.target, target[:40, :40])
    np.testing.assert_array_equal(view.w, w[:40, :40])
    del target, w
    assert ref() is None


def test_a_solve_that_raises_leaves_no_view_copy_running(monkeypatch, inputs):
    """A `_solve` that raises while the view is copied from its tiles: the
    request raises the solve's error after the copy has finished, and no
    helper thread is left running."""
    from chromosome3d_tpu_torch.io import load_if_matrix

    made = []

    class SlowCopy(port_pipeline._TileViewCopy):
        def __init__(self, *a, **k):
            made.append(self)
            super().__init__(*a, **k)

        def _copy(self, stream):
            time.sleep(0.2)
            super()._copy(stream)

    def boom(*a, **k):
        raise RuntimeError("solve failed")

    monkeypatch.setattr(port_pipeline, "_TileViewCopy", SlowCopy)
    monkeypatch.setattr(port_pipeline, "_solve", boom)
    cfg = _port_cfg(**PAST)
    with pytest.raises(RuntimeError, match="solve failed"):
        SolverCache(cfg, device="cpu").solve(load_if_matrix(inputs[40]), cfg)
    (copy,) = made
    assert not copy.thread.is_alive() and copy.view is not None and copy.tiles is None
    assert not [t for t in threading.enumerate() if t.name == "c3d-view-copy"]


def test_a_failed_view_copy_raises_in_the_request(monkeypatch, inputs):
    """An error inside the view's copy is raised by the request, in its
    own thread, once the solve is done."""
    from chromosome3d_tpu_torch.io import load_if_matrix

    def broken(target):
        raise MemoryError("no room for the view")

    monkeypatch.setattr(port_pipeline, "restraints_from_exact_target", broken)
    cfg = _port_cfg(**PAST)
    with pytest.raises(MemoryError, match="no room for the view"):
        SolverCache(cfg, device="cpu").solve(load_if_matrix(inputs[40]), cfg)
    assert not [t for t in threading.enumerate() if t.name == "c3d-view-copy"]


def test_queue_depth_cap(tmp_path):
    """Requests past MAX_QUEUE solves in flight are refused at once and do
    not leak the counter (no thread needed: the counter preloaded)."""
    cache = SolverCache(_port_cfg(), device="cpu")
    cache.busy = MAX_QUEUE
    path = tmp_path / "one.rr"
    path.write_text("1 2 3.8 3.8 1.0\n")
    resp = handle_request({"restraints": str(path), "out": str(tmp_path / "x")}, cache)
    assert not resp["ok"] and "busy" in resp["error"], resp
    assert cache.busy == MAX_QUEUE


def test_matrix_request_keeps_operator_restraint_config(tmp_path, monkeypatch):
    """A matrix request without alpha/kscaling solves with the operator's
    base restraint config; explicit request fields override it."""
    base = PipelineConfig(model_count=2, restraints=RestraintConfig(alpha=1.1, kscaling=7.0))
    cache = SolverCache(base, device="cpu")
    seen = {}

    def fake_solve(self, matrix, cfg):
        seen["rc"] = cfg.restraints
        raise RuntimeError("stop after capture")

    monkeypatch.setattr(SolverCache, "solve", fake_solve)
    src = tmp_path / "m.txt"
    np.savetxt(src, [[9.0, 2.0], [2.0, 9.0]], fmt="%.1f")
    with pytest.raises(RuntimeError, match="stop after capture"):
        handle_request({"matrix": str(src), "out": str(tmp_path / "o")}, cache)
    assert seen["rc"].alpha == 1.1 and seen["rc"].kscaling == 7.0
    with pytest.raises(RuntimeError, match="stop after capture"):
        handle_request({"matrix": str(src), "out": str(tmp_path / "o"), "alpha": 0.7,
                        "kscaling": 12.0}, cache)
    assert seen["rc"].alpha == 0.7 and seen["rc"].kscaling == 12.0
    assert cache.busy == 0


def test_restraint_request_marks_warm(server, inputs, tmp_path):
    """A restraint-file request registers the padded length it solved at
    (summary["L_solved"]) in the warm set."""
    resp = request(server, {"restraints": inputs["rr"], "out": str(tmp_path / "o"),
                            "models": 2})
    assert resp["ok"] and resp["summary"]["L_solved"] == 64
    pong = request(server, {"cmd": "ping"})
    assert pong["warm_buckets"] == [[64, 2, fast_anneal(AnnealConfig()).total_steps]]


# ---- the port's own ------------------------------------------------------


@pytest.mark.parametrize("where", ["bucket", "past"])
def test_served_matrix_request_equals_run(inputs, tmp_path, where):
    """Every file a served matrix request writes equals, byte for byte, the
    same-named file of run_pipeline on the same matrix and config (the run
    writes into the same directory first, which is then moved aside, so
    model_info.log's paths agree): the same restraints, the same draws
    (a generator seeded cfg.seed) and the same route, within the buckets
    and past them (the prep on the device)."""
    L, kw = (35, {}) if where == "bucket" else (40, PAST)
    cfg = _port_cfg(**kw)
    out = str(tmp_path / "out")
    summary_run = port_pipeline.run_pipeline(inputs[L], out, cfg, device="cpu")
    os.rename(out, str(tmp_path / "run"))
    cache = SolverCache(cfg, device="cpu")
    resp = handle_request({"matrix": inputs[L], "out": out, "models": 2}, cache)
    assert resp["ok"], resp
    served = sorted(os.listdir(out))
    assert f"chr{L}_matrix_model1.pdb" in served and "contact_violation.txt" in served
    for name in served:
        with open(os.path.join(out, name), "rb") as a, \
                open(tmp_path / "run" / name, "rb") as b:
            assert a.read() == b.read(), name
    for k, v in resp["summary"].items():
        assert summary_run[k] == v, k
    assert cache.warm_snapshot() == [(64 if where == "bucket" else 48, 2,
                                      cfg.anneal.total_steps)]


def test_a_traced_served_request_views_the_solve_tiles(inputs, tmp_path, monkeypatch):
    """A served request past the buckets under a profiler: its files are
    byte for byte run_pipeline's (untraced), its root holds the two
    `prep.view` spans of the copy from the solve's tiles (its launch and
    its join, source "solve_tiles") and the copy's `xfer.d2h` records, one
    a tile and row block (blocks of 16 rows here: 16, 16, 8), with the
    view's bytes."""
    from torch.profiler import ProfilerActivity, profile

    from chromosome3d_tpu_torch.utils import trace

    cfg = _port_cfg(**PAST)
    out = str(tmp_path / "out")
    port_pipeline.run_pipeline(inputs[40], out, cfg, device="cpu")
    os.rename(out, str(tmp_path / "run"))
    # rows of the padded 48 columns: blocks of 16 rows
    monkeypatch.setattr(port_pipeline, "VIEW_BLOCK_BYTES", 16 * 48 * 4)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        resp = handle_request({"matrix": inputs[40], "out": out, "models": 2},
                              SolverCache(cfg, device="cpu"))
    assert resp["ok"], resp
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name), "rb") as a, \
                open(tmp_path / "run" / name, "rb") as b:
            assert a.read() == b.read(), name
    recs = trace.records()
    (root,) = [r for r in recs if r.name == "request"]
    views = [r for r in recs if r.name == "prep.view"]
    copies = [r for r in recs if r.name == "xfer.d2h"]
    assert len(views) == 2 and all(v.attrs["source"] == "solve_tiles" for v in views)
    assert all(v.parent == root.id for v in views)
    assert views[0].t1 <= views[1].t0
    assert [c.attrs["bytes"] for c in copies] == [16 * 40 * 4] * 4 + [8 * 40 * 4] * 2
    for c in copies + views:
        assert c.request == root.request and c.parent == root.id
        assert root.t0 <= c.t0 <= c.t1 <= root.t1
    assert all(views[0].t0 <= c.t0 and c.t1 <= views[1].t1 for c in copies)


def _sequence(inputs, out):
    """One request sequence for both packages' handle_request."""
    wide = os.path.join(os.path.dirname(inputs[20]), "wide_matrix.txt")
    if not os.path.exists(wide):
        with open(wide, "w") as f:   # the first row alone names L = MAX_L + 1
            f.write(" ".join(["1"] * (srv.MAX_L + 1)) + "\n")
    huge = os.path.join(os.path.dirname(inputs[20]), "huge.rr")
    if not os.path.exists(huge):
        with open(huge, "w") as f:
            f.write(f"1 {srv.MAX_L + 5} 3.8 3.8 1.0\n")
    seq = [{"cmd": "ping"}]
    seq += [{"matrix": inputs[L], "out": os.path.join(out, f"m{L}"), "models": 2}
            for L in (20, 22, 40)]
    seq += [req for req, _ in _bound_cases(inputs[20], os.path.join(out, "x"))]
    seq += [{"matrix": wide, "out": os.path.join(out, "w")},
            {"restraints": huge, "out": os.path.join(out, "h")},
            {"restraints": inputs["rr"], "out": os.path.join(out, "rr"), "models": 2},
            {"cmd": "ping"}]
    return seq


def _answers(responses):
    """What both packages must agree on: ok, the error strings, the warm
    buckets (as lists)."""
    keep = []
    for r in responses:
        a = {"ok": r["ok"], "error": r.get("error")}
        if "warm_buckets" in r:
            a["warm_buckets"] = [list(w) for w in r["warm_buckets"]]
            a["busy"] = r["busy"]
        keep.append(a)
    return keep


@pytest.fixture(scope="module")
def jax_answers(inputs, tmp_path_factory):
    """The JAX package's server on the CPU (its plain route; one device, as
    its own test of the beyond-bucket route forces)."""
    out = str(tmp_path_factory.mktemp("jax_serve"))
    cfg = JaxPipelineConfig(anneal=jax_fast_anneal(JaxAnnealConfig(use_pallas=False)), **PAST)
    real = jax_pipeline._use_sharded
    jax_pipeline._use_sharded = lambda L, c: False
    try:
        cache = jax_serve.SolverCache(cfg)
        return _answers([jax_serve.handle_request(req, cache)
                         for req in _sequence(inputs, out)])
    finally:
        jax_pipeline._use_sharded = real


def test_same_requests_as_jax(inputs, tmp_path, jax_answers):
    """The same requests to the JAX package's handle_request/SolverCache and
    to the port's: equal ok flags, error strings and warm buckets, a
    past-bucket L (40 -> the quantum bucket 48) and a restraint file
    among them."""
    cache = SolverCache(PipelineConfig(anneal=fast_anneal(AnnealConfig()), **PAST),
                        device="cpu")
    got = _answers([handle_request(req, cache) for req in _sequence(inputs, str(tmp_path))])
    assert got == jax_answers
    fast = fast_anneal(AnnealConfig()).total_steps
    assert got[-1]["warm_buckets"] == [[16, 2, fast], [24, 2, fast], [48, 2, fast]]


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().strip().splitlines()


def test_cli_serve_and_submit(inputs, tmp_path, capsys):
    """`serve --device cpu` through the CLI on a thread, then `submit`:
    --ping, -i/-o, -r/-o, the JAX CLI's exit codes for a refused request
    (1) and bad arguments (2), and --shutdown, after which `serve` returns
    0 and the socket is gone."""
    d = tempfile.mkdtemp(prefix="c3d")
    sock = os.path.join(d, "s.sock")
    done = {}
    t = threading.Thread(target=lambda: done.update(rc=cli.main(
        ["serve", "--socket", sock, "--device", "cpu", "--turbo"])), daemon=True)
    t.start()
    try:
        rc, lines = _cli(["submit", "--socket", sock, "--ping"])
        assert rc == 0 and json.loads(lines[-1])["warm_buckets"] == []
        out = str(tmp_path / "o")
        rc, lines = _cli(["submit", "--socket", sock, "-i", inputs[35], "-o", out,
                          "-m", "1", "-a", "0.7"])
        resp = json.loads(lines[-1])
        assert rc == 0 and resp["ok"] and resp["summary"]["L"] == 35
        assert os.path.isfile(os.path.join(out, "chr35_matrix_rank01_a07.pdb"))
        rc, lines = _cli(["submit", "--socket", sock, "-r", inputs["rr"], "-o",
                          str(tmp_path / "r"), "-m", "1"])
        assert rc == 0 and json.loads(lines[-1])["summary"]["restraints"] == 9
        rc, lines = _cli(["submit", "--socket", sock, "-i", "/nonexistent.txt", "-o", out])
        assert rc == 1 and "does not exist" in json.loads(lines[-1])["error"]
        assert _cli(["submit", "--socket", sock, "-i", inputs[35], "-r", inputs["rr"],
                     "-o", out])[0] == 2
        assert _cli(["submit", "--socket", sock, "-i", inputs[35]])[0] == 2
        assert "-i OR -r" in capsys.readouterr().err
        rc, lines = _cli(["submit", "--socket", sock, "--ping"])
        # the server's base schedule is turbo's (`serve --turbo`)
        n = turbo_anneal(AnnealConfig()).total_steps
        assert json.loads(lines[-1])["warm_buckets"] == [[512, 1, n]]
        rc, lines = _cli(["submit", "--socket", sock, "--shutdown"])
        assert rc == 0 and json.loads(lines[-1])["bye"]
        t.join(timeout=10)
        assert not t.is_alive() and done["rc"] == 0 and not os.path.exists(sock)
    finally:
        if t.is_alive():
            request(sock, {"cmd": "shutdown"}, timeout=5)
        shutil.rmtree(d, ignore_errors=True)


def test_client_imports_no_torch(tmp_path):
    """`submit` and serve.request import neither torch nor the solver (nor
    jax): the CLI's submit branch in a fresh interpreter."""
    code = (
        "import sys\n"
        "from chromosome3d_tpu_torch import cli, serve\n"
        "assert cli.main(['submit', '--socket', 'none.sock', '-i', 'm.txt']) == 2\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', "
        "'chromosome3d_tpu') or m.startswith('chromosome3d_tpu_torch.solver')]\n"
        "assert not bad, bad\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr


def test_server_without_a_card_raises_at_start(monkeypatch, tmp_path):
    """The default device is the card: without one SolverCache raises, and
    serve raises before it binds its socket; it never serves on the CPU
    unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SolverCache(_port_cfg())
    sock = str(tmp_path / "s.sock")
    for argv in (None, ["serve", "--socket", sock]):
        with pytest.raises(RuntimeError, match="CUDA"):
            if argv is None:
                serve(sock, _port_cfg())
            else:
                cli.main(argv)
        assert not os.path.exists(sock)
