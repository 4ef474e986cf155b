"""The port's beyond-bucket `run` (a .npy input past every length bucket)
vs the JAX package's single-device at-scale route, on the CPU.

A 72-bead structured matrix with length_buckets=(32,) and shard_quantum=32
pads to 96, as test_scale_dispatch.py's single-device case does for JAX.
The port's route is forced onto the semi path (B3 + B4), which the card
takes past L_pad = 2048. The run must build its restraints on the device
(no host prep), suppress the O(L^2) text artifacts, emit the same artifact
set and restraint count as the JAX run, and reconstruct (best
Spearman(IF, 1/d) > 0.7); the same run in a subprocess that blocks jax.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from chromosome3d_tpu import pipeline as jax_pipeline
from chromosome3d_tpu_torch import pipeline as port_pipeline
from chromosome3d_tpu_torch.ops import tri_energy
from chromosome3d_tpu_torch.ops.fused_step import fused_step_plain
from chromosome3d_tpu_torch.ops.fused_update import fused_update_plain
from chromosome3d_tpu_torch.ops.pair_energy import exact_pair_energy_grad_plain
from tests.test_scale_dispatch import scale_cfg, structured_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _always(*args, **kwargs):
    return True


@pytest.fixture
def npy(tmp_path):
    path = tmp_path / "big_matrix.npy"
    np.save(path, structured_matrix(72, seed=12).astype(np.float32))
    return str(path)


def _boom(*a, **k):
    raise AssertionError("the at-scale run must not prep restraints on the host")


def test_at_scale_npy_run_matches_jax(tmp_path, npy, monkeypatch):
    cfg = scale_cfg()
    monkeypatch.setattr(jax_pipeline, "_use_sharded", lambda L, c: False)
    ref = jax_pipeline.run_pipeline(npy, str(tmp_path / "jax"), cfg)

    for name in ("if_to_dist", "dist_to_restraints", "_padded_dense",
                 "exact_restraints_from_numpy", "dense_restraints_from_numpy"):
        monkeypatch.setattr(port_pipeline, name, _boom)
    monkeypatch.setattr(tri_energy, "use_triangular", _always)
    counts = (tri_energy.tri_energy_grad_plain.calls, fused_update_plain.calls,
              fused_step_plain.calls, exact_pair_energy_grad_plain.calls)
    out = str(tmp_path / "port")
    got = port_pipeline.run_pipeline(npy, out, cfg, device="cpu")
    steps = cfg.anneal.total_steps
    assert (tri_energy.tri_energy_grad_plain.calls - counts[0],
            fused_update_plain.calls - counts[1],
            fused_step_plain.calls - counts[2],
            exact_pair_energy_grad_plain.calls - counts[3]) == (steps + 1, steps, 0, 0)

    assert sorted(os.listdir(out)) == sorted(os.listdir(tmp_path / "jax"))
    for name in ("big_matrix.dist", "big_matrix.rr", "contact.tbl", "big_matrix.txt"):
        assert not os.path.exists(os.path.join(out, name)), name
    assert got["L"] == 72 and got["restraints"] == ref["restraints"]
    assert got["best_spearman_if_inv_d"] > 0.7
    assert set(got["phases"]) == {"load_s", "host_prep_s", "device_prep_s", "solve_s",
                                  "alpha_ensemble_s", "assess_view_s", "assess_emit_s"}
    hist = np.load(os.path.join(out, "trajectory.npz"))["energy_history"]
    assert hist.shape == (2, steps) and np.isfinite(hist).all()


def test_at_scale_npy_run_without_jax(tmp_path, npy):
    """The at-scale path never imports jax or the JAX package: block both and
    run it."""
    out = str(tmp_path / "out")
    code = (
        "import json, sys; sys.modules['jax'] = sys.modules['chromosome3d_tpu'] = None\n"
        "from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, "
        "RestraintConfig, fast_anneal\n"
        "from chromosome3d_tpu_torch.ops import tri_energy\n"
        "from chromosome3d_tpu_torch.pipeline import run_pipeline\n"
        "tri_energy.use_triangular = lambda L, for_unfused=False, batch=None, device=None: True\n"
        "cfg = PipelineConfig(model_count=2, restraints=RestraintConfig(alpha=0.5), "
        "anneal=fast_anneal(AnnealConfig(), 0.05), length_buckets=(32,), shard_quantum=32)\n"
        f"s = run_pipeline({npy!r}, {out!r}, cfg, device='cpu')\n"
        "assert not any(m.split('.')[0] in ('jax', 'chromosome3d_tpu') "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "print(json.dumps(s))\n"
    )
    # one torch thread: more spin on the run's small ops and slow the
    # tests running beside it
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["L"] == 72 and summary["best_spearman_if_inv_d"] > 0.7
    assert os.path.isfile(os.path.join(out, "big_matrix_rank01_a05.pdb"))
    assert not os.path.exists(os.path.join(out, "contact.tbl"))
