"""The port's pipelines on the row-sharded route, on the CPU: past the
largest length bucket with more than one shard device, `run` and `solve`
pad to a multiple of lcm(shard_quantum, shards), cut the restraints into
row strips and run solver.sharded (the kernels' plain twins here). The
shard devices are faked as repeated CPU devices by replacing
device.shard_devices, as chip_smoke.py repeats the card.

Covered: `run` on an 800-bead matrix (-> 1024, 2 shards, strip prep, B6's
twin), `solve` on a windowed `.rr` (4 shards, B5''s twin, two-sided
sharded landmark start) and on an exact one (2 shards, B2''s twin), the
row-sharded device prep against the one-shot prep, and the artifact set
and summary fields.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from chromosome3d_tpu_torch import device as device_mod
from chromosome3d_tpu_torch import pipeline
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu_torch.ops import device_prep, fused_update, general_pair, pair_energy
from chromosome3d_tpu_torch.ops import strip_tri, tri_energy
from chromosome3d_tpu_torch.parallel.shards import ShardGroup
from chromosome3d_tpu_torch.solver import anneal, sharded
from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

TWINS = {
    "B6": strip_tri.strip_tri_energy_grad_plain,
    "B5'": general_pair.general_row_block_energy_grad_plain,
    "B2'": pair_energy.exact_row_block_energy_grad_plain,
    "B4": fused_update.fused_update_plain,
    "B3": tri_energy.tri_energy_grad_plain,
    "B5": general_pair.general_pair_energy_grad_plain,
    "B2": pair_energy.exact_pair_energy_grad_plain,
}


@pytest.fixture(autouse=True)
def _one_thread():
    """The pipelines here run thousands of small ops: one torch thread is
    about as fast and leaves the cores to the tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _calls():
    return {k: fn.calls for k, fn in TWINS.items()}


def _shards(monkeypatch, n):
    """n shard devices, all the CPU; with n > 1 the pipeline's reading of a
    device's memory is patched to 0, so that a one-device solve does not
    fit and the pipeline shards."""
    monkeypatch.setattr(device_mod, "shard_devices", lambda: [torch.device("cpu")] * n)
    if n > 1:
        monkeypatch.setattr(pipeline, "_memory_bytes", lambda dev: 0)


def test_use_sharded_needs_shard_devices(monkeypatch):
    cfg = PipelineConfig()
    _shards(monkeypatch, 1)
    assert not pipeline._use_sharded(800, cfg)
    _shards(monkeypatch, 2)
    assert pipeline._use_sharded(800, cfg) and not pipeline._use_sharded(768, cfg)
    assert not pipeline._use_sharded(800, cfg.replace(shard_large=False))
    assert pipeline.quantum_bucket(800, 512, 2) == 1024
    assert pipeline.quantum_bucket(800, 512, 3) == 1536
    assert pipeline.quantum_bucket(1000, 512, 1) == 1024


def test_sharded_device_prep_matches_one_shot():
    """Each rank's strip is the one-shot prep's rows: the global mean of
    IF^alpha and the mean-1 weight normalisation are combined over ranks."""
    X = confined_walk(90, seed=3)
    m = if_from_structure(X, 0.5, 0.1, 3)
    rc = RestraintConfig()
    for weighting in ("relative", "absolute"):
        one = device_prep.exact_tiles_from_if_device(m, 128, rc, weighting, 1.0, device="cpu")
        strips = device_prep.exact_tiles_from_if_device(m, 128, rc, weighting, 1.0,
                                                        group=ShardGroup(["cpu"] * 4))
        assert len(strips) == 4 and all(s.target.shape == (32, 128) for s in strips)
        np.testing.assert_array_equal(torch.cat([s.target for s in strips]).numpy(),
                                      one.target.numpy())
        np.testing.assert_allclose(torch.cat([s.w for s in strips]).numpy(),
                                   one.w.numpy(), rtol=1e-6)


def test_run_sharded_over_two_shards(tmp_path, monkeypatch):
    """`run` on an 800-bead .npy: L > 768 pads to 1024 over 2 shards, the
    strips are prepped per shard, B6's twin runs on both every step and at
    the pick, B4's once a step; the assessment view is the one-shot prep."""
    _shards(monkeypatch, 2)
    X = confined_walk(800, seed=7)
    npy = str(tmp_path / "chrT_800.npy")
    np.save(npy, if_from_structure(X, 0.5, 0.1, 7).astype(np.float32))
    preps = []
    real = device_prep.exact_tiles_from_if_device

    def spy(*a, **k):
        out = real(*a, **k)
        preps.append(len(out) if isinstance(out, list) else 1)
        return out

    monkeypatch.setattr(device_prep, "exact_tiles_from_if_device", spy)
    cfg = PipelineConfig(model_count=2, anneal=fast_anneal(AnnealConfig(), 0.04),
                         emit_violation_reports=False)
    before = _calls()
    summary = pipeline.run_pipeline(npy, str(tmp_path / "out"), cfg, device="cpu")
    calls = {k: v - before[k] for k, v in _calls().items()}
    steps = cfg.anneal.total_steps
    assert calls == {"B6": 2 * (steps + 1), "B5'": 0, "B2'": 0, "B4": steps,
                     "B3": 0, "B5": 0, "B2": 0}
    assert preps == [2, 1]
    assert summary["L"] == 800 and summary["models"] == 2
    assert set(summary["phases"]) == {"load_s", "host_prep_s", "device_prep_s", "solve_s",
                                      "alpha_ensemble_s", "assess_view_s", "assess_emit_s"}
    assert summary["best_spearman_if_inv_d"] > 0.7
    out = tmp_path / "out"
    names = set(os.listdir(out))
    assert {"chrT_800_model1.pdb", "chrT_800_rank01_a05.pdb", "spearman.txt",
            "model_info.log", "summary.json", "trajectory.npz", "chrT_800.fasta"} <= names
    assert not names & {"chrT_800.dist", "chrT_800.rr", "contact.tbl"}
    hist = np.load(out / "trajectory.npz")["energy_history"]
    assert hist.shape == (2, steps) and np.isfinite(hist).all()
    with open(out / "chrT_800_rank01_a05.pdb") as f:
        assert sum(line.startswith("ATOM") for line in f) == 800


def _write_rr(path, n, exact, seed=7):
    X = confined_walk(n, seed=seed)
    rng = np.random.default_rng(seed)
    ii, jj = np.triu_indices(n, 1)
    d = np.linalg.norm(X[ii] - X[jj], axis=1) * np.exp(0.05 * rng.standard_normal(len(ii)))
    om = 0.0 if exact else rng.uniform(0.05, 0.15, len(ii))
    conf = rng.uniform(0.5, 1.0, len(ii))
    with open(path, "w") as f:
        for a, b, lo, hi, c in zip(ii + 1, jj + 1, d * (1 - om), d * (1 + om), conf):
            f.write("%d %d %.2f %.2f %.3f\n" % (a, b, lo, hi, c))


@pytest.mark.parametrize("exact,n,twin", [(False, 4, "B5'"), (True, 2, "B2'")])
def test_solve_sharded(tmp_path, monkeypatch, exact, n, twin):
    """`solve` past a bucket of 16 beads: 30 beads pad to 32 over n shards;
    windowed rows take B5''s twin and the two-sided sharded landmark start,
    exact ones B2''s twin (32 beads in 2 strips span only 2 tiles)."""
    _shards(monkeypatch, n)
    rr = str(tmp_path / "w.rr")
    _write_rr(rr, 30, exact)
    inits = []
    real = sharded.sharded_landmark_init
    monkeypatch.setattr(sharded, "sharded_landmark_init",
                        lambda *a, **k: inits.append(a[3].embed_two_sided) or real(*a, **k))
    cfg = PipelineConfig(model_count=2, anneal=fast_anneal(AnnealConfig(), 0.1),
                         length_buckets=(16,), shard_quantum=16)
    before = _calls()
    summary = pipeline.run_restraints_pipeline(rr, str(tmp_path / "out"), cfg, device="cpu")
    calls = {k: v - before[k] for k, v in _calls().items()}
    steps = cfg.anneal.total_steps
    want = {k: 0 for k in TWINS}
    want.update({twin: n * (steps + 1), "B4": steps})
    assert calls == want
    assert inits == [not exact]
    assert summary["L"] == 30 and summary["L_solved"] == 32
    assert summary["restraints"] == summary["total"] == 30 * 29 // 2
    assert summary["satisfied"] > 0.4 * summary["total"]
    assert set(summary) == {"id", "L", "L_solved", "restraints", "or_groups", "models",
                            "best_noe_energy", "satisfied", "total", "wall_seconds", "phases"}
    for name in ("w_model1.pdb", "w_model2.pdb", "w_violation.txt", "model_info.log"):
        assert os.path.isfile(tmp_path / "out" / name), name
    with open(tmp_path / "out" / "summary.json") as f:
        assert json.load(f)["best_noe_energy"] == summary["best_noe_energy"]


def test_use_sharded_keeps_a_fitting_length_on_one_device(monkeypatch):
    """Past the buckets with two shard devices the pipeline shards only where
    the one-device solve's estimate exceeds the device: an 800-bead solve
    fits the host's memory and stays on one device; with the memory read as
    one byte short of its estimate it shards."""
    cfg = PipelineConfig()
    monkeypatch.setattr(device_mod, "shard_devices", lambda: [torch.device("cpu")] * 2)
    assert not pipeline._use_sharded(800, cfg)
    need = pipeline.solve_peak_bytes(1024, 2 * cfg.model_count, exact=True)
    monkeypatch.setattr(pipeline, "_memory_bytes", lambda dev: need)
    assert not pipeline._use_sharded(800, cfg)
    monkeypatch.setattr(pipeline, "_memory_bytes", lambda dev: need - 1)
    assert pipeline._use_sharded(800, cfg)
    # the windowed solve holds more planes: its own estimate decides
    need_w = pipeline.solve_peak_bytes(1024, 2 * cfg.model_count, exact=False)
    assert need_w > need
    monkeypatch.setattr(pipeline, "_memory_bytes", lambda dev: need_w)
    assert pipeline._use_sharded(800, cfg, exact=True) is False
    assert pipeline._use_sharded(800, cfg, exact=False) is False
    monkeypatch.setattr(pipeline, "_memory_bytes", lambda dev: need_w - 1)
    assert pipeline._use_sharded(800, cfg, exact=False)


def test_sharded_pipelines_pass_the_chunked_terms_gate(tmp_path, monkeypatch):
    """`run` past the chunked final terms' gate (patched down so that
    L = 800 -> 1024 is past it): one device solves with the row-chunked
    terms, and so does a shard group with its own column-chunked terms."""
    calls = []
    real = anneal.energy_terms_chunked
    monkeypatch.setattr(anneal, "energy_terms_chunked",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    monkeypatch.setattr(anneal, "CHUNKED_TERMS_MIN_L", 1024)
    X = confined_walk(800, seed=7)
    npy = str(tmp_path / "chrT_800.npy")
    np.save(npy, if_from_structure(X, 0.5, 0.1, 7).astype(np.float32))
    cfg = PipelineConfig(model_count=1, emit_violation_reports=False,
                         anneal=dataclasses.replace(
                             AnnealConfig(), hot_steps=2, cool_cycles=1,
                             cool_steps_per_cycle=1, final_steps=1))
    _shards(monkeypatch, 1)
    one = pipeline.run_pipeline(npy, str(tmp_path / "one"), cfg, device="cpu")
    assert calls == [(1, 1024, 3)]
    assert one["L"] == 800 and np.isfinite(one["best_spearman_if_inv_d"])
    _shards(monkeypatch, 2)
    summary = pipeline.run_pipeline(npy, str(tmp_path / "two"), cfg, device="cpu")
    assert calls == [(1, 1024, 3)]
    assert summary["L"] == 800 and np.isfinite(summary["best_spearman_if_inv_d"])


def test_sharded_prep_gates_on_strip_bytes_per_device(monkeypatch):
    """The sharded prep's memory gate: each rank holds one (L_pad / n, L_pad)
    strip, a device listed k times k of them; the whole matrix on the lead
    is not the measure."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    whole = device_prep.prep_peak_bytes(64)
    assert device_prep.strip_prep_peak_bytes(64, [cpu] * 4) == {cpu: whole}
    assert device_prep.strip_prep_peak_bytes(64, [cpu, meta, cpu, meta]) == {
        cpu: whole // 2, meta: whole // 2}
    assert device_prep.strip_prep_peak_bytes(64, [cpu, meta]) == {
        cpu: whole // 2, meta: whole // 2}
    # memory for just under the whole matrix at a quarter share: one device
    # listed twice must stream, two distinct devices need not
    monkeypatch.setattr(device_prep, "_memory_bytes", lambda dev: 4 * whole - 1)
    assert device_prep.should_stream_prep(64, cpu)
    assert device_prep.should_stream_strip_prep(64, [cpu, cpu])
    assert not device_prep.should_stream_strip_prep(64, [cpu, meta])
    m = if_from_structure(confined_walk(60, seed=3), 0.5, 0.1, 3).astype(np.float32)
    rc = RestraintConfig()
    with pytest.raises(NotImplementedError, match="no streamed form"):
        device_prep.exact_tiles_from_if_device(m, 64, rc, rc.weighting, 1.0,
                                               group=ShardGroup([cpu, cpu]))
