"""The port's CLI flags: the shard switches it shares with the JAX CLI,
`--device` (the card by default, the CPU only when asked for), and the JAX
CLI's flags that are registered but not ported — each refused with a
NotImplementedError naming its ROADMAP item, never by argparse."""

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
def test_cli_refuses_unported_flags_by_name(argv, flag):
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
