"""The port's dispatch table and its calibrator (ops/tri_energy.py's reader,
ops/calibrate.py, `calibrate` on the CLI) against the JAX package's.

The first sixteen tests mirror tests/test_dispatch_calibration.py case by
case with fake timers, on the port's functions. Its seventeenth,
test_packaged_table_precedes_user_cache, has no counterpart: the port ships
no table (the JAX package's data/dispatch_v5e.json holds TPU seconds), so
CHROM3D_DISPATCH_TABLE or the user cache is the only source; the env-over-
packaged case becomes env over the user cache. Then the route decision of
both packages on the same table files, keyed "cpu" (the device kind of the
CPU in both) and read through CHROM3D_DISPATCH_TABLE, over a grid of L,
batch and for_unfused (with CHROM3D_NO_TRI set too), the solver's
step_route held to the described route, and `calibrate` on the CPU through
the CLI. The B3 tile differs (the port's 64, the JAX package's 128 or
more), so the grid starts at L = 320, where both have at least 3 tiles.
"""

import json
import os

import pytest
import torch

from chromosome3d_tpu.ops import pallas_energy as jax_pe
from chromosome3d_tpu_torch import cli
from chromosome3d_tpu_torch.config import AnnealConfig
from chromosome3d_tpu_torch.ops import calibrate as port_cal
from chromosome3d_tpu_torch.ops import tri_energy as pe
from chromosome3d_tpu_torch.ops.calibrate import calibrate_dispatch, verify_dispatch
from chromosome3d_tpu_torch.ops.tri_energy import (
    _DISPATCH_CACHE,
    describe_dispatch,
    dispatch_table_fingerprint,
    use_triangular,
)
from chromosome3d_tpu_torch.solver import anneal


@pytest.fixture(autouse=True)
def _one_thread():
    """The solves here run thousands of small ops: one torch thread is about
    as fast and leaves the cores to the tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def table_path(tmp_path, monkeypatch):
    p = str(tmp_path / "dispatch.json")
    monkeypatch.setenv("CHROM3D_DISPATCH_TABLE", p)
    _DISPATCH_CACHE.clear()
    yield p
    _DISPATCH_CACHE.clear()


@pytest.fixture()
def fake_kind(monkeypatch):
    monkeypatch.setattr(pe, "_device_kind", lambda device=None: "fakeGPU")


def fake_timer(times):
    def timer(variant, L, B):
        return times.get((variant, L))

    return timer


def test_calibration_writes_and_flips_dispatch(table_path, monkeypatch):
    times = {}
    for L in (1024, 2048, 4096):
        times[("fused", L)] = 0.10 if L <= 2048 else None
        times[("semi", L)] = 0.50
        times[("tri_unfused", L)] = 0.50
        times[("row_unfused", L)] = 0.10
    table = calibrate_dispatch(lengths=(1024, 2048, 4096), repeats=5,
                               timer=fake_timer(times), device_kind="fakeGPU")
    entries = {e["L"]: e for e in table["fakeGPU"]["entries"]}
    assert entries[4096]["fused_s"] is None
    assert entries[1024]["B"] == 4
    with open(table_path) as f:
        text = f.read()
    assert "Infinity" not in text
    assert json.loads(text)["fakeGPU"]["repeats"] == 5
    monkeypatch.setattr(pe, "_device_kind", lambda device=None: "fakeGPU")
    assert not use_triangular(2048)
    assert not use_triangular(4096, for_unfused=True)
    assert use_triangular(4096)


def test_calibration_tri_wins_everywhere(table_path, fake_kind):
    times = {}
    for L in (512, 1024):
        times[("fused", L)] = 0.50
        times[("semi", L)] = 0.10
        times[("tri_unfused", L)] = 0.10
        times[("row_unfused", L)] = 0.50
    calibrate_dispatch(lengths=(512, 1024), repeats=3, timer=fake_timer(times),
                       device_kind="fakeGPU")
    assert use_triangular(1024)
    # the structural >= 3 tiles rule still gates it: 512 has 8 of the port's
    assert use_triangular(512) == (-(-512 // pe.TILE) >= 3)
    assert not use_triangular(128)


def test_without_table_frozen_defaults(monkeypatch, tmp_path):
    monkeypatch.setenv("CHROM3D_DISPATCH_TABLE", str(tmp_path / "missing.json"))
    _DISPATCH_CACHE.clear()
    assert dispatch_table_fingerprint() == "none"
    assert not use_triangular(1024)
    assert not use_triangular(2048)
    assert use_triangular(2176)
    assert use_triangular(1024, for_unfused=True)
    monkeypatch.setenv("CHROM3D_NO_TRI", "1")
    assert not use_triangular(4096)
    _DISPATCH_CACHE.clear()


def test_merge_preserves_other_lengths(table_path):
    t1 = {("fused", 1024): 0.1, ("semi", 1024): 0.2,
          ("tri_unfused", 1024): 0.2, ("row_unfused", 1024): 0.1}
    calibrate_dispatch(lengths=(1024,), repeats=2, timer=fake_timer(t1), device_kind="fakeGPU")
    t2 = {("fused", 2048): 0.3, ("semi", 2048): 0.1,
          ("tri_unfused", 2048): 0.1, ("row_unfused", 2048): 0.3}
    table = calibrate_dispatch(lengths=(2048,), repeats=2, timer=fake_timer(t2),
                               device_kind="fakeGPU")
    assert [e["L"] for e in table["fakeGPU"]["entries"]] == [1024, 2048]
    assert dispatch_table_fingerprint() != "none"


def test_merge_distinguishes_batches(table_path, fake_kind):
    def timer_b(variant, L, B):
        if variant == "fused":
            return 0.10 if B <= 8 else 0.50
        if variant == "semi":
            return 0.50 if B <= 8 else 0.10
        return 0.60

    calibrate_dispatch(cases=((1024, 2), (1024, 16)), repeats=2, timer=timer_b,
                       device_kind="fakeGPU")
    table = json.load(open(os.environ["CHROM3D_DISPATCH_TABLE"]))
    assert [(e["L"], e["B"]) for e in table["fakeGPU"]["entries"]] == [(1024, 2), (1024, 16)]
    assert not use_triangular(1024, batch=2)
    assert use_triangular(1024, batch=20)
    assert use_triangular(1024) in (True, False)


def test_sparse_table_distance_bound(table_path, fake_kind):
    times = {("fused", 4096): None, ("semi", 4096): 0.1,
             ("tri_unfused", 4096): 0.1, ("row_unfused", 4096): 0.5}
    calibrate_dispatch(lengths=(4096,), repeats=2, timer=fake_timer(times),
                       device_kind="fakeGPU")
    assert not use_triangular(1024)
    assert not use_triangular(1024, for_unfused=False)
    assert use_triangular(4096)
    assert use_triangular(4096, for_unfused=True)
    assert use_triangular(2176)


def test_feasible_query_ignores_infeasible_entry(table_path, fake_kind):
    times = {("fused", 2560): None, ("semi", 2560): 0.1,
             ("tri_unfused", 2560): 0.1, ("row_unfused", 2560): 0.5}
    calibrate_dispatch(lengths=(2560,), repeats=2, timer=fake_timer(times),
                       device_kind="fakeGPU")
    assert not use_triangular(2048)
    assert use_triangular(2560)


def test_legacy_table_with_infinity_loads_and_merges(table_path, fake_kind):
    legacy = {"fakeGPU": {"entries": [{
        "L": 4096, "fused_s": float("inf"), "semi_s": 0.1,
        "tri_unfused_s": 0.1, "row_unfused_s": 0.5, "rel_spread": {}}],
        "repeats": 5, "steps": 24, "batch": 4}}
    with open(table_path, "w") as f:
        f.write(json.dumps(legacy))
    _DISPATCH_CACHE.clear()
    assert use_triangular(4096)
    t1 = {("fused", 1024): 0.1, ("semi", 1024): 0.5,
          ("tri_unfused", 1024): 0.5, ("row_unfused", 1024): 0.1}
    table = calibrate_dispatch(lengths=(1024,), repeats=2, timer=fake_timer(t1),
                               device_kind="fakeGPU")
    pairs = [(e["L"], e.get("B", None)) for e in table["fakeGPU"]["entries"]]
    assert pairs == [(1024, 4), (4096, None)]
    assert "Infinity" not in open(table_path).read()
    assert "batch" not in table["fakeGPU"]
    assert use_triangular(4096)


def _write_table(path, kind, L, fused_s, semi_s, tri_s=0.5, row_s=0.5, B=4):
    entry = {"L": L, "B": B, "fused_s": fused_s, "semi_s": semi_s,
             "tri_unfused_s": tri_s, "row_unfused_s": row_s, "rel_spread": {}}
    with open(path, "w") as f:
        json.dump({kind: {"entries": [entry], "repeats": 2, "steps": 24}}, f)


def test_env_override_wins_over_the_user_cache(tmp_path, monkeypatch, fake_kind):
    """The JAX package's env-over-packaged case, on the port's two sources:
    the user cache (~/.cache/chromosome3d_torch/dispatch.json, HOME pointed
    into tmp) steers routing with no override, and CHROM3D_DISPATCH_TABLE,
    once set, alone; `calibrate` writes where the reader reads."""
    monkeypatch.delenv("CHROM3D_DISPATCH_TABLE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    usr = tmp_path / ".cache" / "chromosome3d_torch" / "dispatch.json"
    usr.parent.mkdir(parents=True)
    _write_table(str(usr), "fakeGPU", 1024, fused_s=0.10, semi_s=0.50)
    _DISPATCH_CACHE.clear()
    assert pe._dispatch_source() == ("user", str(usr))
    assert not use_triangular(1024)
    assert pe._active_dispatch("fakeGPU")[1] == "user"
    assert dispatch_table_fingerprint().startswith("user:")
    override = tmp_path / "override.json"
    _write_table(str(override), "fakeGPU", 1024, fused_s=0.50, semi_s=0.10)
    monkeypatch.setenv("CHROM3D_DISPATCH_TABLE", str(override))
    _DISPATCH_CACHE.clear()
    assert use_triangular(1024)
    fp = dispatch_table_fingerprint()
    assert fp.startswith("env:") and "user" not in fp
    assert pe._dispatch_source() == ("env", str(override))
    _DISPATCH_CACHE.clear()


def test_spread_gate_rejects_poisoned_case(table_path, fake_kind):
    clean = {("fused", 1024): 0.10, ("semi", 1024): 0.20,
             ("tri_unfused", 1024): 0.20, ("row_unfused", 1024): 0.20}
    calibrate_dispatch(lengths=(1024,), repeats=3, timer=fake_timer(clean),
                       device_kind="fakeGPU")
    calls = {"n": 0}

    def poisoned(variant, L, B):
        if variant == "fused":
            calls["n"] += 1
            return 0.30 if calls["n"] % 2 else 0.60
        return 0.25

    table = calibrate_dispatch(lengths=(1024,), repeats=4, timer=poisoned,
                               device_kind="fakeGPU")
    entries = {e["L"]: e for e in table["fakeGPU"]["entries"]}
    assert entries[1024]["fused_s"] == 0.10
    assert table["fakeGPU"]["rejected"][0]["L"] == 1024
    assert not use_triangular(1024)


def test_quiet_host_check():
    port_cal._check_quiet_host(1e9)
    try:
        os.getloadavg()
    except (AttributeError, OSError):
        pytest.skip("no getloadavg on this platform")
    with pytest.raises(RuntimeError, match="not quiet"):
        port_cal._check_quiet_host(-1.0)


def test_verify_dispatch_reports_drift(table_path):
    clean = {("fused", 1024): 0.10, ("semi", 1024): 0.20,
             ("tri_unfused", 1024): 0.20, ("row_unfused", 1024): 0.20}
    calibrate_dispatch(lengths=(1024,), repeats=2, timer=fake_timer(clean),
                       device_kind="fakeGPU")
    drifted = {("fused", 1024): 0.30, ("semi", 1024): 0.05,
               ("tri_unfused", 1024): 0.20, ("row_unfused", 1024): 0.20}
    report = verify_dispatch(repeats=2, timer=fake_timer(drifted), device_kind="fakeGPU")
    assert report["source"] == "env"
    (row,) = report["entries"]
    assert row["fused"]["drift_pct"] == 200.0
    assert row["choice_stored"] == "fused"
    assert row["choice"] == "semi"
    assert row["choice_changed"]


def test_describe_dispatch_matches_anneal(table_path, fake_kind):
    """describe_dispatch mirrors solver.anneal.step_route: a table that
    flips the solver's route flips the description too."""
    times = {}
    for L in (1024, 2048):
        times[("fused", L)] = 0.50
        times[("semi", L)] = 0.10
        times[("tri_unfused", L)] = 0.10
        times[("row_unfused", L)] = 0.50
    calibrate_dispatch(lengths=(1024, 2048), repeats=2, timer=fake_timer(times),
                       device_kind="fakeGPU")
    d = describe_dispatch(1024, batch=20, exact=True)
    assert d["route"] == "semi"
    exact_cfg = AnnealConfig(exact_restraints=True)
    assert d["route"] == anneal.step_route(exact_cfg, 1024, None, 20)
    assert d["table_source"] == "env"
    assert d["table_entry"]["L"] == 1024
    assert d["tile_tri"] == pe.TILE and d["tile_fused"] is not None
    assert describe_dispatch(8192, batch=4)["route"] == "semi"
    assert not describe_dispatch(8192, batch=4)["fused_feasible"]
    assert describe_dispatch(8192, batch=4)["tile_fused"] is None
    general = describe_dispatch(512, batch=20, exact=False)
    assert general["route"] == "semi_general"
    assert anneal.step_route(AnnealConfig(noe_rswitch=5.0), 512, None, 20) == "semi"
    unfused = describe_dispatch(512, batch=20, fusable=False)
    assert unfused["route"] in ("unfused_tri", "unfused_row")
    assert anneal.step_route(AnnealConfig(fuse_update=False), 512, None, 20) == "unfused"


def test_frozen_defaults_describe(monkeypatch, tmp_path):
    monkeypatch.setenv("CHROM3D_DISPATCH_TABLE", str(tmp_path / "missing.json"))
    _DISPATCH_CACHE.clear()
    d = describe_dispatch(456, batch=20, exact=True)
    assert d["route"] == "fused"
    assert d["table_source"] == "none"
    assert d["table_fingerprint"] == "none"
    assert d["device_kind"] == "cpu"
    _DISPATCH_CACHE.clear()


def test_verify_uses_each_entrys_protocol(table_path):
    table = {"fakeGPU": {"entries": [
        {"L": 1024, "B": 4, "steps": 24, "fused_s": 0.10, "semi_s": 0.20,
         "tri_unfused_s": 0.20, "row_unfused_s": 0.20, "rel_spread": {}},
        {"L": 2048, "B": 4, "steps": 960, "fused_s": 4.00, "semi_s": 8.00,
         "tri_unfused_s": 8.00, "row_unfused_s": 8.00, "rel_spread": {}},
    ], "repeats": 2, "steps": 960}}
    with open(table_path, "w") as f:
        json.dump(table, f)
    _DISPATCH_CACHE.clear()

    def timer(variant, L, B):
        return {1024: 0.1, 2048: 4.0}[L] * (2.0 if variant != "fused" else 1.0)

    report = verify_dispatch(repeats=1, timer=timer, device_kind="fakeGPU")
    rows = {r["L"]: r for r in report["entries"]}
    assert rows[1024]["steps"] == 24
    assert rows[2048]["steps"] == 960
    assert rows[1024]["fused"]["drift_pct"] == 0.0
    assert rows[2048]["fused"]["drift_pct"] == 0.0
    assert not rows[1024]["choice_changed"]


def test_verify_choice_mirrors_reader(table_path):
    table = {"fakeGPU": {"entries": [
        {"L": 2048, "B": 4, "steps": 960, "fused_s": None, "semi_s": 1.0,
         "tri_unfused_s": 1.0, "row_unfused_s": 1.0, "rel_spread": {}},
        {"L": 4096, "B": 4, "steps": 960, "fused_s": None, "semi_s": 1.0,
         "tri_unfused_s": 1.0, "row_unfused_s": 2.0, "rel_spread": {}},
    ], "repeats": 2, "steps": 960}}
    with open(table_path, "w") as f:
        json.dump(table, f)
    _DISPATCH_CACHE.clear()

    def timer(variant, L, B):
        return None if variant == "fused" else 1.0

    report = verify_dispatch(repeats=1, timer=timer, device_kind="fakeGPU")
    rows = {r["L"]: r for r in report["entries"]}
    assert rows[2048]["choice_stored"] == "fused"
    assert rows[4096]["choice_stored"] == "semi"
    assert not rows[2048]["choice_changed"]
    assert not rows[4096]["choice_changed"]


# ---- the route decision of both packages on shared table files ----


def _entry(L, B, fused, semi, tri, row):
    return {"L": L, "B": B, "steps": 960, "fused_s": fused, "semi_s": semi,
            "tri_unfused_s": tri, "row_unfused_s": row, "rel_spread": {}}


TABLES = {
    "none": None,
    # one entry far from the production shapes: 2x distance bound
    "sparse": {"cpu": {"entries": [_entry(4096, 4, None, 0.1, 0.1, 0.5)]}},
    # the production cases, with crossovers that differ by batch
    "measured": {"cpu": {"entries": [
        _entry(512, 10, 0.10, 0.12, 0.30, 0.20), _entry(512, 20, 0.20, 0.15, 0.20, 0.30),
        _entry(1024, 4, 0.30, 0.29, 0.40, 0.30), _entry(2048, 4, 0.50, 0.60, 0.50, 0.70),
        _entry(4096, 4, None, 1.0, 1.2, 1.1)]}},
    # entries silent on fused (null) where it is and is not feasible
    "infeasible": {"cpu": {"entries": [
        _entry(1024, 20, None, 0.1, 0.2, 0.1), _entry(2560, 20, None, 0.1, 0.1, 0.5)]}},
    # a round-3 table: no B, the Infinity token
    "legacy": {"cpu": {"entries": [
        {"L": 2048, "fused_s": float("inf"), "semi_s": 0.1, "tri_unfused_s": 0.3,
         "row_unfused_s": 0.2, "rel_spread": {}},
        {"L": 768, "fused_s": 0.2, "semi_s": 0.1, "tri_unfused_s": 0.1,
         "row_unfused_s": 0.2, "rel_spread": {}}], "repeats": 5, "steps": 24, "batch": 4}},
}
GRID_L = (320, 456, 512, 768, 1024, 1536, 2048, 2176, 2560, 4096, 5120)
GRID_B = (None, 1, 4, 10, 20)


@pytest.mark.parametrize("no_tri", [False, True], ids=["", "no_tri"])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_route_decision_matches_jax(name, no_tri, tmp_path, monkeypatch):
    path = tmp_path / "dispatch.json"
    if TABLES[name] is not None:
        path.write_text(json.dumps(TABLES[name]))
    monkeypatch.setenv("CHROM3D_DISPATCH_TABLE", str(path))
    if no_tri:
        monkeypatch.setenv("CHROM3D_NO_TRI", "1")
    _DISPATCH_CACHE.clear()
    jax_pe._DISPATCH_CACHE.clear()
    try:
        for L in GRID_L:
            for B in GRID_B:
                for for_unfused in (False, True):
                    assert use_triangular(L, for_unfused, B) == jax_pe.use_triangular(
                        L, for_unfused, B), (L, B, for_unfused)
                for exact, fusable, og in ((True, True, False), (True, True, True),
                                           (False, True, False), (True, False, False)):
                    got = describe_dispatch(L, B, exact, fusable, og)
                    ref = jax_pe.describe_dispatch(L, B, exact, fusable, og)
                    assert sorted(got) == sorted(ref)
                    # the solver's own choice is the one described
                    cfg = AnnealConfig(exact_restraints=exact, fuse_update=fusable,
                                       noe_rswitch=1e9 if exact else 5.0)
                    assert anneal.step_route(cfg, L, object() if og else None, B) == {
                        "fused": "fused", "semi": "semi", "semi_general": "semi",
                        "unfused_row": "unfused", "unfused_tri": "unfused"}[got["route"]]
                    for k in ("route", "L", "batch", "fused_feasible", "device_kind",
                              "table_source", "table_entry"):
                        assert got[k] == ref[k], (k, L, B, exact, fusable, og)
    finally:
        _DISPATCH_CACHE.clear()
        jax_pe._DISPATCH_CACHE.clear()


def test_cli_calibrate_on_the_cpu(tmp_path, monkeypatch, capsys):
    """`calibrate --device cpu` at two tiny cases (a few steps, 2 repeats,
    the kernels' plain versions; the gate opened, as CPU timings of a few
    milliseconds spread): the file holds every variant's seconds (null for
    the fused step past its reach), the JSON printed is the file, and the
    reader follows it; `--verify` reports the two entries."""
    out = tmp_path / "t.json"
    monkeypatch.setenv("CHROM3D_DISPATCH_TABLE", str(out))
    _DISPATCH_CACHE.clear()
    assert cli.main(["calibrate", "-L", "192x2,2100", "--batch", "1", "--steps", "2",
                     "--repeats", "2", "--out", str(out), "--spread-gate", "1e9",
                     "--device", "cpu", "--force"]) == 0
    printed = json.loads(capsys.readouterr().out)
    table = json.loads(out.read_text())
    assert printed == table and sorted(table) == ["cpu"]
    entries = table["cpu"]["entries"]
    assert [(e["L"], e["B"], e["steps"]) for e in entries] == [(192, 2, 2), (2100, 1, 2)]
    assert entries[1]["fused_s"] is None and entries[0]["fused_s"] > 0
    for e in entries:
        assert all(e[f"{v}_s"] > 0 for v in ("semi", "tri_unfused", "row_unfused"))
    e = entries[0]
    assert use_triangular(192, True, 2) == (e["tri_unfused_s"] < 0.97 * e["row_unfused_s"])
    assert cli.main(["calibrate", "--verify", "--repeats", "2", "--device", "cpu",
                     "--force"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["source"] == "env" and [r["L"] for r in report["entries"]] == [192, 2100]
    _DISPATCH_CACHE.clear()
