"""The port's `solve` path (run_restraints_pipeline and the CLI) on the CPU.

Given the same coordinates and energies, the port and the JAX package must
hand their solvers the same tensors and write the same bytes: both solvers
are replaced by one fake that records its inputs and returns fixed
structures. The port's own solves then run end to end at small shapes on
the kernels' plain twins: a windowed `.rr` takes the two-sided init and the
semi-general route (B5 + B4), an exact one the fused route (B1), and the
CLI runs `solve` on a `.tbl` with or-groups in a subprocess where importing
jax or the JAX package fails. Past the buckets with two shard devices the
`solve` runs the row-sharded route.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chromosome3d_tpu import pipeline as jax_pipeline
from chromosome3d_tpu.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu.restraints import write_contact_tbl
from chromosome3d_tpu.truth import confined_walk
from chromosome3d_tpu_torch import device as device_mod
from chromosome3d_tpu_torch import pipeline as port_pipeline
from chromosome3d_tpu_torch.ops.fused_step import fused_step_plain
from chromosome3d_tpu_torch.ops.fused_update import fused_update_plain
from chromosome3d_tpu_torch.ops.general_pair import general_pair_energy_grad_plain
from chromosome3d_tpu_torch.ops.pair_energy import exact_pair_energy_grad_plain
from chromosome3d_tpu_torch.solver import anneal as port_anneal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 30


def write_rr(path, exact=False, seed=7):
    """An `.rr` over every pair of a ground-truth chain: windows of +-5-15 %
    around noisy distances (lo == hi when exact), confidences in [0.5, 1]."""
    X = confined_walk(N, seed=seed)
    rng = np.random.default_rng(seed)
    ii, jj = np.triu_indices(N, 1)
    d = np.linalg.norm(X[ii] - X[jj], axis=1) * np.exp(0.05 * rng.standard_normal(len(ii)))
    om = 0.0 if exact else rng.uniform(0.05, 0.15, len(ii))
    conf = rng.uniform(0.5, 1.0, len(ii))
    with open(path, "w") as f:
        for a, b, lo, hi, c in zip(ii + 1, jj + 1, d * (1 - om), d * (1 + om), conf):
            f.write("%d %d %.2f %.2f %.3f\n" % (a, b, lo, hi, c))
    return X


def write_tbl(path, rr_path, X):
    """carr2tbl of the `.rr`, plus three or-group rows around the truth."""
    write_contact_tbl(path, rr_path, RestraintConfig())
    with open(path, "a") as f:
        for i, j1, j2 in ((2, 10, 20), (5, 15, 25), (8, 12, 29)):
            d = min(np.linalg.norm(X[i - 1] - X[j - 1]) for j in (j1, j2))
            f.write(f"assign (resid {i} and name ca) ((resid {j1} and name ca) or "
                    f"(resid {j2} and name ca)) {d:.2f} {0.1 * d:.2f} {0.1 * d:.2f}\n")


class FakeSolve:
    """Stands in for both packages' solvers: records what it was given and
    returns the same structures and energies."""

    def __init__(self, n_models, L_pad, seed=0):
        rng = np.random.RandomState(seed)
        self.coords = (rng.randn(n_models, L_pad, 3) * 6).astype(np.float32)
        self.energies = {k: rng.rand(n_models).astype(np.float32) * 100
                         for k in ("noe", "bon", "vdw", "overall")}
        self.seen = {}

    def result(self, pkg, restraints, cfg, bm, og):
        self.seen[pkg] = (restraints, cfg, bm, og)
        return port_anneal.AnnealResult(
            coords=torch.from_numpy(self.coords),
            energies={k: torch.from_numpy(v) for k, v in self.energies.items()},
            history=torch.zeros(len(self.coords), 1))


@pytest.mark.parametrize("kind", ["rr", "tbl"])
def test_solve_matches_jax_given_same_coords(tmp_path, monkeypatch, kind):
    rr = str(tmp_path / "ext.rr")
    X = write_rr(rr)
    path = rr
    if kind == "tbl":
        path = str(tmp_path / "ext.tbl")
        write_tbl(path, rr, X)
    cfg = PipelineConfig(model_count=4)
    fake = FakeSolve(4, 512)
    monkeypatch.setattr(
        jax_pipeline, "_aot_solve",
        lambda dense, an, key, n, bm, or_groups=None: fake.result("jax", dense, an, bm, or_groups))
    monkeypatch.setattr(
        port_pipeline, "solve_ensemble_impl",
        lambda r, an, n, bm, or_groups=None, generator=None: fake.result("port", r, an, bm, or_groups))
    out = tmp_path / "out"
    summaries = {}
    for name, mod in (("jax", jax_pipeline), ("port", port_pipeline)):
        out.mkdir()
        kw = {"device": "cpu"} if mod is port_pipeline else {}
        summaries[name] = mod.run_restraints_pipeline(path, str(out), cfg, **kw)
        out.rename(tmp_path / name)
    phases = summaries["port"].pop("phases")
    assert set(phases) == {"host_prep_s", "tensor_prep_s", "solve_s", "assess_emit_s"}
    for s in summaries.values():
        s.pop("wall_seconds")
    assert summaries["port"] == summaries["jax"]
    assert summaries["port"]["L_solved"] == 512
    assert summaries["port"]["or_groups"] == (3 if kind == "tbl" else 0)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "ext_violation.txt" in names and "ext_model1.pdb" in names
    for name in set(names) - {"summary.json"}:   # its wall and phases differ
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes(), name

    # the solvers got the same tensors: windows, confidences folded after
    # the mean-1 normalisation, padding, or-groups; the same config
    r_j, an_j, bm_j, og_j = fake.seen["jax"]
    r_p, an_p, bm_p, og_p = fake.seen["port"]
    assert an_p == an_j and an_p.embed_two_sided and not an_p.exact_restraints
    for f in ("lo", "hi", "mask", "weight"):
        np.testing.assert_array_equal(getattr(r_p, f).numpy(), np.asarray(getattr(r_j, f)))
    np.testing.assert_array_equal(bm_p.numpy(), np.asarray(bm_j))
    assert (og_p is None) == (og_j is None) == (kind == "rr")
    if og_p is not None:
        for f in ("idx_i", "idx_j", "member", "lo", "hi", "weight"):
            np.testing.assert_array_equal(getattr(og_p, f).numpy(), np.asarray(getattr(og_j, f)))


def _small_cfg(models=2):
    """A 32-bead bucket and a 196-step schedule: seconds on the CPU."""
    return PipelineConfig(model_count=models, length_buckets=(32,),
                          anneal=fast_anneal(AnnealConfig(), 0.1))


def _counts():
    return (general_pair_energy_grad_plain.calls, fused_update_plain.calls,
            fused_step_plain.calls, exact_pair_energy_grad_plain.calls)


def test_windowed_rr_runs_two_sided_semi_general(tmp_path, monkeypatch):
    rr = str(tmp_path / "w.rr")
    write_rr(rr)
    seen = []
    real = port_anneal.mds_init

    def spy(*args, **kwargs):
        seen.append(kwargs["two_sided"])
        return real(*args, **kwargs)

    monkeypatch.setattr(port_anneal, "mds_init", spy)
    cfg = _small_cfg()
    before = _counts()
    summary = port_pipeline.run_restraints_pipeline(rr, str(tmp_path / "o"), cfg,
                                                    device="cpu")
    steps = cfg.anneal.total_steps
    assert tuple(a - b for a, b in zip(_counts(), before)) == (steps + 1, steps, 0, 0)
    assert seen == [True]
    assert summary["L"] == N and summary["L_solved"] == 32
    assert summary["restraints"] == summary["total"] == N * (N - 1) // 2
    assert summary["satisfied"] > 0.5 * summary["total"]


def test_exact_rr_takes_the_fused_route(tmp_path):
    rr = str(tmp_path / "x.rr")
    write_rr(rr, exact=True)
    cfg = _small_cfg()
    before = _counts()
    summary = port_pipeline.run_restraints_pipeline(rr, str(tmp_path / "o"), cfg,
                                                    device="cpu")
    steps = cfg.anneal.total_steps
    # B1 every step, B2 for the pick; no B5, no B4
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 0, steps, 1)
    assert np.isfinite(summary["best_noe_energy"])


def test_solve_refuses_before_allocating(tmp_path, monkeypatch):
    rr = str(tmp_path / "w.rr")
    write_rr(rr)
    with pytest.raises(ValueError, match="exceeds the cap"):
        port_pipeline.run_restraints_pipeline(rr, str(tmp_path / "a"), max_L=20,
                                              device="cpu")

    def boom(*a, **k):
        raise AssertionError("the solve tensors were built")

    monkeypatch.setattr(port_pipeline, "_padded_dense", boom)
    # padded to 8192 on one device: no longer refused as unported (the run
    # goes on to build its tensors, here the fake above), but refused, with
    # the row-sharded route named, where its estimate exceeds the device
    big = PipelineConfig(length_buckets=(8,), shard_quantum=8192)
    with pytest.raises(AssertionError, match="the solve tensors were built"):
        port_pipeline.run_restraints_pipeline(rr, str(tmp_path / "b"), big, device="cpu")
    need = port_pipeline.solve_peak_bytes(8192, 2 * big.model_count, exact=False)
    monkeypatch.setattr(port_pipeline, "_memory_bytes", lambda dev: need - 1)
    with pytest.raises(RuntimeError, match="row-sharded route"):
        port_pipeline.run_restraints_pipeline(rr, str(tmp_path / "b"), big, device="cpu")
    # several shard devices past the buckets, and a one-device solve that
    # does not fit: the row-sharded solve runs (padded to lcm(shard_quantum,
    # shards))
    monkeypatch.undo()
    monkeypatch.setattr(device_mod, "shard_devices", lambda: [torch.device("cpu")] * 2)
    monkeypatch.setattr(port_pipeline, "_memory_bytes", lambda dev: 0)
    cfg = PipelineConfig(model_count=2, length_buckets=(8,), shard_quantum=8,
                         anneal=fast_anneal(AnnealConfig(), 0.1))
    summary = port_pipeline.run_restraints_pipeline(rr, str(tmp_path / "c"), cfg,
                                                    device="cpu")
    assert summary["L"] == N and summary["L_solved"] == 32
    assert np.isfinite(summary["best_noe_energy"])


def test_cli_solve_tbl_without_jax(tmp_path):
    """`solve` on a `.tbl` with or-groups through the CLI, jax and the JAX
    package blocked."""
    rr = str(tmp_path / "g.rr")
    X = write_rr(rr)
    tbl = str(tmp_path / "g.tbl")
    write_tbl(tbl, rr, X)
    out = str(tmp_path / "out")
    code = (
        "import sys; sys.modules['jax'] = sys.modules['chromosome3d_tpu'] = None\n"
        "from chromosome3d_tpu_torch.cli import main\n"
        f"rc = main(['solve', '-r', {tbl!r}, '-o', {out!r}, '-m', '2', '--fast',"
        " '--device', 'cpu'])\n"
        "assert not any(m.split('.')[0] in ('jax', 'chromosome3d_tpu') for m in sys.modules if sys.modules[m] is not None)\n"
        "sys.exit(rc)\n"
    )
    # one torch thread: more spin on the run's small ops and slow the
    # tests running beside it
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["or_groups"] == 3 and summary["L_solved"] == 512
    assert summary["total"] == N * (N - 1) // 2 + 3
    for name in ("g_model1.pdb", "g_model2.pdb", "g_violation.txt", "model_info.log",
                 "summary.json"):
        assert os.path.isfile(os.path.join(out, name)), name
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f)["best_noe_energy"] == summary["best_noe_energy"]
