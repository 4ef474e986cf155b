"""The port's pipeline, artifacts and CLI, on the CPU.

The artifact writers are host numpy in both packages: given the same
coordinates and energies they must write the same bytes. The CLI runs end
to end on the 16-bead fixture (padded to the 512 bucket), once in process
and once in a subprocess where importing jax or the JAX package fails.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chromosome3d_tpu import cli as jax_cli
from chromosome3d_tpu import pipeline as jax_pipeline
from chromosome3d_tpu.config import PipelineConfig
from chromosome3d_tpu.io.matrix import write_if_matrix
from chromosome3d_tpu.ops.energy import dense_restraints_from_numpy
from chromosome3d_tpu.restraints import build_restraints, if_to_dist, write_rr
from chromosome3d_tpu_torch import cli as port_cli
from chromosome3d_tpu_torch import pipeline as port_pipeline
from chromosome3d_tpu_torch.config import PipelineConfig as PortPipelineConfig, fast_anneal
from chromosome3d_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("{id}.fasta", "{id}.dist", "{id}.rr", "contact.tbl",
             "contact_violation.txt", "model_info.log", "spearman.txt",
             "summary.json", "trajectory.npz", "{id}_model1.pdb",
             "{id}_rank01_a05.pdb")


def _assert_artifact_set(out, ident, n_models):
    for name in ARTIFACTS:
        assert os.path.isfile(os.path.join(out, name.format(id=ident))), name
    assert len(glob.glob(os.path.join(out, f"{ident}_rank*_a05.pdb"))) == n_models
    assert not os.path.exists(os.path.join(out, "iam.running"))
    assert not os.path.exists(os.path.join(out, "iam.failed"))
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert summary["models"] == n_models and summary["L"] == 16
    assert set(summary["phases"]) == {
        "load_s", "host_prep_s", "solve_s", "alpha_ensemble_s", "assess_emit_s"}
    # rounded to 0.01 s, as the JAX package's (chromosome3d_tpu/pipeline.py)
    assert all(v == round(v, 2) for v in summary["phases"].values())
    hist = np.load(os.path.join(out, "trajectory.npz"))["energy_history"]
    assert hist.shape[0] == n_models and np.isfinite(hist).all()
    return summary


@pytest.mark.parametrize("reports", [True, False])
def test_emit_artifacts_byte_identical(tmp_path, tiny_matrix, reports):
    cfg = PipelineConfig(model_count=3, emit_violation_reports=reports)
    r = build_restraints(tiny_matrix, cfg.restraints)
    dense = dense_restraints_from_numpy(r, as_numpy=True)
    rng = np.random.RandomState(0)
    coords = rng.randn(3, 16, 3) * 8
    energies = {k: rng.rand(3) * 100 for k in ("noe", "bon", "vdw", "overall")}
    outs = []
    # one output path for both (model_info.log records the PDB paths)
    out = tmp_path / "out"
    for name, mod in (("jax", jax_pipeline), ("port", port_pipeline)):
        out.mkdir()
        outs.append(mod.emit_artifacts(str(out), "chrX", coords, energies,
                                       tiny_matrix, r, dense, cfg))
        out.rename(tmp_path / name)
    assert outs[0] == outs[1]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert ("contact_violation.txt" in names) == reports
    for name in names:
        a = (tmp_path / "jax" / name).read_bytes()
        assert a == (tmp_path / "port" / name).read_bytes(), name


def test_cli_run_full_artifact_set(tmp_path, tiny_matrix, capsys):
    path = str(tmp_path / "chrT_matrix.txt")
    write_if_matrix(path, tiny_matrix)
    out = str(tmp_path / "out")
    assert port_cli.main(["run", "-i", path, "-o", out, "-m", "2", "--fast",
                          "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    summary = _assert_artifact_set(out, "chrT_matrix", 2)
    assert printed["best_noe_energy"] == summary["best_noe_energy"]
    # the spearman subcommand scores the emitted models as the JAX CLI does
    assert port_cli.main(["spearman", path, out]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "SRCC\tPDB" and len(lines) == 1 + 2 + 2   # model + rank PDBs
    assert jax_cli.main(["spearman", path, out]) == 0
    assert capsys.readouterr().out.strip().splitlines() == lines


def test_cli_run_without_jax(tmp_path, tiny_matrix):
    """The port never imports jax or the JAX package: block both and run the
    CLI smoke."""
    path = str(tmp_path / "chrT_matrix.txt")
    write_if_matrix(path, tiny_matrix)
    out = str(tmp_path / "out")
    code = (
        "import sys; sys.modules['jax'] = sys.modules['chromosome3d_tpu'] = None\n"
        "import chromosome3d_tpu_torch\n"
        "from chromosome3d_tpu_torch.cli import main\n"
        f"rc = main(['run', '-i', {path!r}, '-o', {out!r}, '-m', '2', '--turbo', '--fast',"
        " '--device', 'cpu'])\n"
        "assert not any(m.split('.')[0] in ('jax', 'chromosome3d_tpu') for m in sys.modules if sys.modules[m] is not None)\n"
        "sys.exit(rc)\n"
    )
    # one torch thread: more spin on the run's small ops and slow the
    # tests running beside it
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    _assert_artifact_set(out, "chrT_matrix", 2)


def test_run_pipeline_refuses_unported_inputs(tmp_path, tiny_matrix, monkeypatch):
    from chromosome3d_tpu.pipeline import run_pipeline as jax_run_pipeline

    # a .cool input is ported (io.hic): one that is not a cooler file dies in
    # its loader, with the JAX package's exception (h5py's OSError, or the
    # ImportError where h5py is missing), before any artifact is written
    cool = str(tmp_path / "m.cool")
    with open(cool, "wb") as f:
        f.write(b"not read")
    raised = []
    for name, run in (("a", lambda o: port_pipeline.run_pipeline(cool, o, device="cpu")),
                      ("a_jax", lambda o: jax_run_pipeline(cool, o))):
        with pytest.raises((OSError, ImportError)) as err:
            run(str(tmp_path / name))
        raised.append(type(err.value))
        assert os.listdir(tmp_path / name) == []
    assert raised[0] is raised[1]
    txt = str(tmp_path / "m.txt")
    write_if_matrix(txt, tiny_matrix)

    def boom(*a, **k):
        raise AssertionError("an (L_pad, L_pad) array was allocated")

    # L = 16 pads to 8192: no longer refused as unported (the run goes on
    # to its first (L_pad, L_pad) array, here the fake above); refused, with
    # the row-sharded route named, before any such allocation where the
    # one-device estimate exceeds the device
    monkeypatch.setattr(port_pipeline.device_prep, "pad_f32", boom)
    monkeypatch.setattr(port_pipeline, "_padded_dense", boom)
    big = PipelineConfig(length_buckets=(8,), shard_quantum=8192)
    with pytest.raises(AssertionError, match="allocated"):
        port_pipeline.run_pipeline(txt, str(tmp_path / "b"), big, device="cpu")
    need = port_pipeline.solve_peak_bytes(8192, 2 * big.model_count, exact=True)
    monkeypatch.setattr(port_pipeline, "_memory_bytes", lambda dev: need - 1)
    with pytest.raises(RuntimeError, match="row-sharded route"):
        port_pipeline.run_pipeline(txt, str(tmp_path / "b"), big, device="cpu")
    # the alpha ensemble is not refused: it runs on to the solve's first
    # (L_pad, L_pad) array (tests/test_torch_alpha_ensemble.py runs it through)
    with pytest.raises(AssertionError, match="allocated"):
        port_pipeline.run_pipeline(txt, str(tmp_path / "c"),
                                   PipelineConfig(alpha_ensemble=(0.7,)), device="cpu")


@pytest.mark.parametrize("command,item", [("coinit", "A11"), ("serve", "A11")])
def test_cli_refuses_unported_subcommands(command, item, capsys):
    """`coinit` (A11.2) and `serve` (A11.3) are ported: each parses its own
    arguments, and without a required one (`-p/--hires-pdb`, `--socket`)
    dies in argparse, not with NotImplementedError."""
    with pytest.raises(SystemExit):
        port_cli.main([command, "-i", "in", "-o", "out"])
    assert ("--hires-pdb" if command == "coinit" else "--socket") in capsys.readouterr().err


def test_cli_solve_runs(tmp_path, tiny_matrix, capsys):
    """`solve` (once refused as unported) runs on a restraint file: the
    matrix pipeline's own `.rr` of the 16-bead fixture, exact restraints."""
    rc = PipelineConfig().restraints
    rr = str(tmp_path / "chrT_matrix.rr")
    write_rr(rr, if_to_dist(tiny_matrix, rc), rc)
    solved = str(tmp_path / "solved")
    assert port_cli.main(["solve", "-r", rr, "-o", solved, "-m", "2", "--fast",
                          "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["L"] == 16 and summary["models"] == 2 and summary["or_groups"] == 0
    for name in ("chrT_matrix_model1.pdb", "chrT_matrix_violation.txt", "summary.json"):
        assert os.path.isfile(os.path.join(solved, name)), name


def test_resolve_device_never_falls_back(monkeypatch, tmp_path):
    """Without a card the default (CUDA) raises, as CUDA asked for does, in
    resolve_device and in both pipelines before they touch anything; the
    CPU is used only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(device)
        with pytest.raises(RuntimeError, match="CUDA"):
            port_pipeline.run_pipeline("unused.txt", str(tmp_path / "a"), device=device)
        with pytest.raises(RuntimeError, match="CUDA"):
            port_pipeline.run_restraints_pipeline("unused.rr", str(tmp_path / "b"),
                                                  device=device)
    assert resolve_device("cpu") == torch.device("cpu")
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()


def test_run_pipeline_wipe(tmp_path, tiny_matrix):
    """run_pipeline removes the files already in the output directory (the
    reference's outdir wipe) and rounds its phase seconds to 0.01 s, as the
    JAX package's does; with wipe=False it keeps them, as the JAX package's
    run_pipeline(wipe=False) does, and writes its artifacts beside them."""
    path = str(tmp_path / "chrT_matrix.txt")
    write_if_matrix(path, tiny_matrix)
    out = tmp_path / "out"
    out.mkdir()
    (out / "stale.txt").write_text("from an earlier run\n")
    cfg = PortPipelineConfig(model_count=2, emit_violation_reports=False)
    cfg = cfg.replace(anneal=fast_anneal(cfg.anneal, 0.05))
    summary = port_pipeline.run_pipeline(path, str(out), cfg, device="cpu")
    assert not (out / "stale.txt").exists()
    assert all(v == round(v, 2) for v in summary["phases"].values())
    (out / "stale.txt").write_text("from an earlier run\n")
    kept = port_pipeline.run_pipeline(path, str(out), cfg, device="cpu", wipe=False)
    assert (out / "stale.txt").read_text() == "from an earlier run\n"
    assert (out / "chrT_matrix_model1.pdb").is_file() and (out / "summary.json").is_file()
    assert kept["models"] == 2
