"""The port's CLI flags: the shard switches it shares with the JAX CLI,
`--device` (the card by default, the CPU only when asked for),
`--alpha-ensemble` on `run` (refused on `solve` with its reason, never by
argparse), `run`'s input and profiling flags, which reach run_pipeline as
the JAX CLI's do; the `genome` subcommand with its `--filter` and
`--resume`; `assess`, `render`, `coinit` and `similarity` reaching their
functions; `serve` and `submit` (tests/test_torch_serve.py runs them); and
the JAX CLI's subcommand still unported, refused with a NotImplementedError
naming its ROADMAP item."""

import json
import os

import pytest

from chromosome3d_tpu import cli as jax_cli
from chromosome3d_tpu_torch import cli

RUN = ["run", "-i", "matrix.txt", "-o", "out"]
SOLVE = ["solve", "-r", "pairs.rr", "-o", "out"]


def _call(argv, monkeypatch, module=cli):
    """(the PipelineConfig, the keyword arguments) the CLI hands its
    pipeline for argv, the pipelines not run."""
    seen = {}

    def fake(path, out, cfg, **kwargs):
        seen["cfg"], seen["kwargs"] = cfg, kwargs
        return {}

    package = module.__name__.rsplit(".", 1)[0]
    for name in ("run_pipeline", "run_restraints_pipeline"):
        monkeypatch.setattr(f"{package}.pipeline.{name}", fake)
    assert module.main(argv) == 0
    return seen["cfg"], seen["kwargs"]


def _parse(argv, monkeypatch, module=cli):
    """The PipelineConfig the CLI builds for argv, the pipelines not run."""
    return _call(argv, monkeypatch, module)[0]


@pytest.mark.parametrize("base", [RUN, SOLVE], ids=["run", "solve"])
@pytest.mark.parametrize("flags,shard_large,quantum", [
    ([], True, 512),
    (["--no-shard-large"], False, 512),
    (["--shard-quantum", "128"], True, 128),
    (["--no-shard-large", "--shard-quantum", "1024"], False, 1024),
])
def test_cli_shard_flags_reach_the_config(monkeypatch, capsys, base, flags, shard_large,
                                          quantum):
    """`--no-shard-large` and `--shard-quantum` set cfg.shard_large and
    cfg.shard_quantum, as the JAX CLI's do."""
    cfg = _parse(base + flags, monkeypatch)
    assert (cfg.shard_large, cfg.shard_quantum) == (shard_large, quantum)
    ref = _parse(base + flags, monkeypatch, jax_cli)
    assert (ref.shard_large, ref.shard_quantum) == (shard_large, quantum)
    capsys.readouterr()


@pytest.mark.parametrize("base", [RUN, SOLVE], ids=["run", "solve"])
@pytest.mark.parametrize("flags,device", [([], "cuda"), (["--device", "cpu"], "cpu"),
                                          (["--device", "cuda"], "cuda")])
def test_cli_device_reaches_the_pipeline(monkeypatch, capsys, base, flags, device):
    """`--device` reaches run_pipeline and run_restraints_pipeline; without
    it they get "cuda", which raises where there is no card."""
    _, kwargs = _call(base + flags, monkeypatch)
    assert kwargs["device"] == device
    capsys.readouterr()


@pytest.mark.parametrize("argv,flag", [
    (RUN + ["--alpha-ensemble", "0.5,0.7"], "--alpha-ensemble"),
    (SOLVE + ["--alpha-ensemble", "0.7"], "--alpha-ensemble"),
    (RUN + ["--profile", "trace_dir"], "--profile"),
    (RUN + ["--chrom", "chr1"], "--chrom"),
    (RUN + ["--resolution", "50000"], "--resolution"),
    (RUN + ["--bed", "bins.bed"], "--bed"),
    (RUN + ["--ice"], "--ice"),
    (RUN + ["--norm", "KR"], "--norm"),
    # given at the JAX CLI's default value: still given, still refused
    (RUN + ["--norm", "NONE"], "--norm"),
    (RUN + ["--alpha-ensemble", ""], "--alpha-ensemble"),
])
def test_cli_refuses_unported_flags_by_name(argv, flag, monkeypatch, capsys):
    """`--alpha-ensemble` on `solve` is refused by name, with its reason:
    the restraint pipeline has no alpha loop, in the JAX package either.
    Every other case is a flag the port now runs: `--alpha-ensemble` on
    `run` reaches the config, an empty value giving none; `--profile`,
    `--chrom`, `--resolution`, `--bed`, `--ice` and `--norm` reach
    run_pipeline with the value the JAX CLI hands its run_pipeline."""
    if argv[0] == "solve":
        with pytest.raises(NotImplementedError,
                           match=rf"`{flag}` is not supported by `solve`: the restraint "
                                 "pipeline has no alpha loop, in the JAX package either"):
            cli.main(argv)
        return
    if flag == "--alpha-ensemble":
        want = tuple(float(a) for a in argv[-1].split(",") if a.strip())
        assert _parse(argv, monkeypatch).alpha_ensemble == want
        assert _parse(argv, monkeypatch, jax_cli).alpha_ensemble == want
        capsys.readouterr()
        return
    key = {"--profile": "profile_dir", "--bed": "bed_path"}.get(flag, flag[2:])
    want = {"--ice": True, "--resolution": 50000}.get(flag, argv[-1])
    _, kwargs = _call(argv, monkeypatch)
    _, ref = _call(argv, monkeypatch, jax_cli)
    assert kwargs[key] == ref[key] == want
    capsys.readouterr()


def test_cli_run_input_flags_default_as_jax(monkeypatch, capsys):
    """Without the flags, run_pipeline gets the JAX CLI's defaults: no
    profile, chrom, resolution or bed, no ICE, and norm "NONE"."""
    _, kwargs = _call(RUN, monkeypatch)
    _, ref = _call(RUN, monkeypatch, jax_cli)
    keys = ("profile_dir", "chrom", "resolution", "bed_path", "ice", "norm")
    assert {k: kwargs[k] for k in keys} == {k: ref[k] for k in keys} == dict(
        profile_dir=None, chrom=None, resolution=None, bed_path=None, ice=False, norm="NONE")
    capsys.readouterr()


@pytest.mark.parametrize("command,item", [("serve", "A11.3"), ("submit", "A11.3"),
                                          ("calibrate", "A11.6")])
def test_cli_refuses_unported_subcommands_by_name(command, item, monkeypatch, capsys):
    """Every JAX CLI subcommand is ported (`serve` and `submit` in A11.3,
    `calibrate` in A11.6), and none is refused as unported. `serve` and
    `calibrate` take the card by default and raise without one before they
    bind a socket or write a table; `submit` with no request exits 2 with
    the JAX CLI's message."""
    assert not hasattr(cli, "_UNPORTED")
    if command in ("serve", "calibrate"):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        argv = [command, "--socket", "s"] if command == "serve" else [
            command, "--out", "t.json", "--force"]
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
        assert not os.path.exists("s") and not os.path.exists("t.json")
    else:
        assert cli.main([command, "--socket", "s"]) == 2
        assert "submit needs -i or -r, and -o" in capsys.readouterr().err


def test_cli_coinit_refuses_alpha_ensemble():
    with pytest.raises(NotImplementedError, match="not supported by `coinit`: .*no alpha loop"):
        cli.main(["coinit", "-i", "m.txt", "-p", "h.pdb", "-o", "out",
                  "--alpha-ensemble", "0.7"])


@pytest.mark.parametrize("command", ["assess", "render", "coinit", "similarity"])
def test_cli_subcommands_reach_their_functions(command, monkeypatch, capsys, tmp_path):
    """`assess`, `render`, `coinit` and `similarity` hand their arguments to
    the port's function (replaced here by a spy) and print its result as the
    JAX CLI does."""
    import numpy as np

    from chromosome3d_tpu_torch import assess, render, similarity
    from chromosome3d_tpu_torch.io import write_ca_pdb, write_if_matrix

    pdb = str(tmp_path / "m.pdb")
    x = np.arange(30, dtype=np.float64).reshape(10, 3)
    write_ca_pdb(pdb, x)
    seen = {}

    def spy(name, result):
        def fn(*args, **kwargs):
            seen[name] = (args, kwargs)
            return result
        return fn

    if command == "assess":
        monkeypatch.setattr(assess, "assess_pdb_vs_tbl", spy("assess", (3, 4, 1.5)))
        assert cli.main(["assess", pdb, "c.tbl", "--relax", "0.25"]) == 0
        args, _ = seen["assess"]
        np.testing.assert_allclose(args[0], x, atol=6e-4)
        assert args[1] == "c.tbl" and args[2].dist_relax == 0.25
        assert capsys.readouterr().out.splitlines()[1].split() == ["3/4", "1.50", pdb]
    elif command == "render":
        monkeypatch.setattr(render, "render_model", spy("model", "m.png"))
        monkeypatch.setattr(render, "render_run", spy("run", ["image.png"]))
        assert cli.main(["render", pdb, "-o", "out.png"]) == 0
        assert cli.main(["render", str(tmp_path)]) == 0
        assert seen["model"][0][1] == "out.png" and seen["run"][0] == (str(tmp_path),)
        assert capsys.readouterr().out.split() == ["m.png", "image.png"]
    elif command == "coinit":
        write_if_matrix(tmp_path / "lo.txt", np.ones((5, 5)))
        coords = np.stack([x[:5], x[:5] * 2.0])
        monkeypatch.setattr(similarity, "solve_coinit",
                            spy("coinit", (coords, np.array([1, 0]), np.array([0.25, 0.5]))))
        out = str(tmp_path / "out")
        assert cli.main(["coinit", "-i", str(tmp_path / "lo.txt"), "-p", pdb, "-o", out,
                         "--factor", "2", "-m", "2", "--device", "cpu"]) == 0
        args, kwargs = seen["coinit"]
        assert args[0].shape == (5, 5) and args[2].model_count == 2
        assert kwargs == {"factor": 2, "device": "cpu"}
        printed = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert printed["best_spearman_if_inv_d"] == 0.5 and printed["models"] == 2
        assert sorted(os.listdir(out)) == ["lo_rank01_a05.pdb", "lo_rank02_a05.pdb"]
    else:
        pairs = {"chr1_500kb_vs_1mb": (pdb, pdb)}
        monkeypatch.setattr(similarity, "pair_outputs_by_chromosome", spy("pairs", pairs))
        monkeypatch.setattr(similarity, "write_reduced_model", spy("reduced", "r.pdb"))
        monkeypatch.setattr(similarity, "similarity_report",
                            spy("report", {"chr1_500kb_vs_1mb": (0.5, 1.25)}))
        assert cli.main(["similarity", "-o", str(tmp_path), "--factor", "3"]) == 0
        assert seen["pairs"][0] == (str(tmp_path),)
        assert seen["reduced"] == ((pdb,), {"factor": 3})
        assert seen["report"][0] == (pairs, f"{tmp_path}/similarity.txt", 3)
        assert capsys.readouterr().out.splitlines() == [
            "chr1_500kb_vs_1mb: spearman=0.5000 rmsd=1.250", f"wrote {tmp_path}/similarity.txt"]


@pytest.mark.parametrize("argv", [RUN + ["--no-such-flag"], SOLVE + ["--ice"],
                                  RUN + ["--device", "gpu"]])
def test_cli_unknown_flags_still_die_in_argparse(argv, capsys):
    """A flag no CLI has — or one the JAX CLI has on another subcommand."""
    with pytest.raises(SystemExit):
        cli.main(argv)
    err = capsys.readouterr().err
    assert "unrecognized arguments" in err or "invalid choice" in err


GENOME = ["genome", "-i", "in", "-o", "out"]


@pytest.mark.parametrize("flags,device", [([], "cuda"), (["--device", "cpu"], "cpu")])
def test_cli_genome_flags_reach_run_genome(monkeypatch, capsys, flags, device):
    """`genome` hands run_genome the jobs `--filter` keeps, `--resume` and
    `--device` (without it "cuda", which raises where there is no card),
    with the common flags in the config."""
    from chromosome3d_tpu_torch.parallel import genome

    seen = {}
    monkeypatch.setattr(genome, "discover_jobs", lambda d: [
        genome.GenomeJob(n, os.path.join(d, n)) for n in ("chr1_1mb", "chr1_500kb")])

    def fake(input_dir, output_dir, cfg, **kwargs):
        seen.update(cfg=cfg, **kwargs)
        return {}

    monkeypatch.setattr(genome, "run_genome", fake)
    assert cli.main(GENOME + ["--filter", "500kb", "--resume", "-m", "3"] + flags) == 0
    assert [j.name for j in seen["jobs"]] == ["chr1_500kb"]
    assert seen["resume"] and seen["device"] == device and seen["cfg"].model_count == 3
    capsys.readouterr()


def _printed_json(out: str):
    """The JSON document the CLI prints last (after the log lines)."""
    lines = out.splitlines()
    return json.loads("\n".join(lines[len(lines) - 1 - lines[::-1].index("{"):]))


def test_cli_genome_runs_on_the_cpu(monkeypatch, capsys, tmp_path):
    """`genome --device cpu --fast -m 2` (once refused as unported) runs a
    directory of three small chromosomes: `--filter 1mb` solves two;
    `--resume` without the filter then solves only the third and reports
    all three. The length bucket is cut to 64 beads here (the CLI pads to
    the 512 bucket) to keep the CPU run to seconds."""
    from chromosome3d_tpu_torch.config import AnnealConfig, fast_anneal
    from chromosome3d_tpu_torch.io import write_if_matrix
    from chromosome3d_tpu_torch.ops.fused_step import fused_step_plain
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

    d = tmp_path / "in"
    d.mkdir()
    for k, (name, L) in enumerate((("chr1_1mb", 40), ("chr2_1mb", 36), ("chr2_500kb", 56))):
        X = confined_walk(L, seed=k)
        write_if_matrix(d / f"{name}_matrix.txt",
                        if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=k))
    make = cli._make_config
    monkeypatch.setattr(cli, "_make_config",
                        lambda args: make(args).replace(length_buckets=(64,)))
    out = str(tmp_path / "out")
    argv = ["genome", "-i", str(d), "-o", out, "--device", "cpu", "--fast", "-m", "2"]
    assert cli.main(argv + ["--filter", "1mb"]) == 0
    first = _printed_json(capsys.readouterr().out)
    assert sorted(first) == ["chr1_1mb", "chr2_1mb"]
    assert all(s["models"] == 2 and s["bucket"] == 64 for s in first.values())
    assert sorted(os.listdir(out)) == ["checkpoint", "chr1_1mb", "chr2_1mb", "summary.json"]

    calls = fused_step_plain.calls
    assert cli.main(argv + ["--resume"]) == 0
    resumed = _printed_json(capsys.readouterr().out)
    assert fused_step_plain.calls - calls == fast_anneal(AnnealConfig()).total_steps
    assert sorted(resumed) == ["chr1_1mb", "chr2_1mb", "chr2_500kb"]
    assert {k: resumed[k] for k in first} == first
    summary = json.load(open(os.path.join(out, "summary.json")))
    assert summary["chromosomes"] == resumed
    assert summary["phases"]["L64"]["chromosomes"] == ["chr2_500kb"]
    assert os.path.isfile(os.path.join(out, "chr2_500kb", "chr2_500kb_model1.pdb"))


def test_cli_run_profile_writes_the_spans_into_its_trace(monkeypatch, capsys, tmp_path):
    """`run --profile DIR --device cpu --fast -m 2` on a small matrix (the
    length bucket cut to 64 beads, as above) writes DIR/trace.json, a
    torch.profiler Chrome trace whose ranges name the solve's phases
    (utils/trace.py), and no copy, since nothing leaves the host
    (tests/test_torch_trace.py runs it on the card, copies named)."""
    from chromosome3d_tpu_torch.io import write_if_matrix
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

    path = tmp_path / "chr7_1mb_matrix.txt"
    write_if_matrix(path, if_from_structure(confined_walk(40, seed=3), alpha=0.5,
                                            noise_sigma=0.1, seed=3))
    make = cli._make_config
    monkeypatch.setattr(cli, "_make_config",
                        lambda args: make(args).replace(length_buckets=(64,)))
    prof = tmp_path / "prof"
    argv = ["run", "-i", str(path), "-o", str(tmp_path / "out"), "--device", "cpu", "--fast",
            "-m", "2", "--profile", str(prof)]
    assert cli.main(argv) == 0
    capsys.readouterr()
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    for name in ("request", "solve.hot", "solve.pick", "solve.cool", "solve.final"):
        assert name in names, name
    assert not [n for n in names if str(n).startswith("xfer.")]
