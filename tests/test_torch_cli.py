"""The port's CLI flags: the shard switches it shares with the JAX CLI,
`--device` (the card by default, the CPU only when asked for),
`--alpha-ensemble` on `run`, and the JAX CLI's flags that are registered
but not ported — each refused with a NotImplementedError naming its ROADMAP
item, never by argparse; and the `genome` subcommand with its `--filter`
and `--resume`."""

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
    """Each unported flag is refused by name. `--alpha-ensemble` is ported
    on `run` (refused on `solve`, whose JAX pipeline has no alpha loop): its
    `run` cases check that the values reach the config, as the JAX CLI's
    do, an empty value giving none."""
    if flag == "--alpha-ensemble" and argv[0] == "run":
        want = tuple(float(a) for a in argv[-1].split(",") if a.strip())
        assert _parse(argv, monkeypatch).alpha_ensemble == want
        assert _parse(argv, monkeypatch, jax_cli).alpha_ensemble == want
        capsys.readouterr()
        return
    with pytest.raises(NotImplementedError, match=rf"`{flag}` is not ported \(ROADMAP A11\)"):
        cli.main(argv)


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
