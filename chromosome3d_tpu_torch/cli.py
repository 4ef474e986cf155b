"""Command-line interface of the port: the `run`, `solve`, `genome` and
`spearman` subcommands of chromosome3d_tpu.cli with the flags the ported
slices support.

  python -m chromosome3d_tpu_torch run -i <IF matrix (.txt or .npy)> -o <outdir> [-k K] [-a ALPHA]
      [-m MODELS] [--fast | --turbo] [--no-violation-reports] [--alpha-ensemble A,B,..]
      [--no-shard-large] [--shard-quantum Q] [--device {cuda,cpu}]
  python -m chromosome3d_tpu_torch solve -r <restraints (.rr or .tbl)> -o <outdir> [-L L]
      [-m MODELS] [--fast | --turbo] [--device {cuda,cpu}]
  python -m chromosome3d_tpu_torch genome -i <dir of chr*_matrix.txt> -o <outdir>
      [--filter SUBSTRING] [--resume] [-m MODELS] [--fast | --turbo]
      [--alpha-ensemble A,B,..] [--device {cuda,cpu}]
  python -m chromosome3d_tpu_torch spearman <matrix> <pdb-or-dir> [range]

`run`, `solve` and `genome` compute on the first CUDA device (the kernels
build at first use) and fail when there is none; `--device cpu` runs them
on the CPU, with the kernels' plain twins, and is the only way onto the
CPU. `genome` solves every `chr*_<res>_matrix.txt` of a directory (those
whose name holds `--filter`), one length bucket at a time (parallel.genome),
past the largest length bucket too; `--resume` skips the chromosomes
already in `<outdir>/checkpoint`. `--alpha-ensemble` (on `run` and
`genome`) solves again for each extra alpha and pools the models into the
Spearman ranking. Past the largest length bucket with more than one CUDA
device visible they row-shard the solve over all of them by themselves
where it would not fit one (pipeline._use_sharded, genome.bucket_devices;
`--no-shard-large` turns that off, `--shard-quantum` sets the padding unit
past the buckets). `solve` takes an external restraint set: CONFOLD-style
`.rr` rows `i j lo hi conf` or a CNS NOE `.tbl`, `or`-group rows included. The
JAX CLI's other subcommands, and its flags that are not ported yet
(`--profile`, `--chrom`, `--resolution`, `--bed`, `--ice`, `--norm`, and
`--alpha-ensemble` on `solve`, whose pipeline has no alpha loop in the JAX
package either), are refused with NotImplementedError naming their ROADMAP
item.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# the JAX CLI's subcommands that are not ported yet, with their ROADMAP item
_UNPORTED = {
    "serve": "A11", "submit": "A11",
    "assess": "A11", "render": "A11", "coinit": "A11", "similarity": "A11",
    "calibrate": "A11",
}
# the JAX CLI's flags that are registered and refused when given, as
# (flag, argparse keywords): `solve`'s, then `run`'s. Each defaults to None,
# so that any value given, the JAX CLI's default too, is told from the
# flag's absence.
_UNPORTED_SOLVE = (
    ("--alpha-ensemble", dict()),
)
_UNPORTED_RUN = (
    ("--profile", dict(metavar="DIR")),
    ("--chrom", dict()),
    ("--resolution", dict(type=int)),
    ("--bed", dict()),
    ("--ice", dict(action="store_true")),
    ("--norm", dict()),
)
_UNPORTED_ITEM = "A11"


def _add_unported(p: argparse.ArgumentParser, flags) -> None:
    for flag, kwargs in flags:
        p.add_argument(flag, default=None,
                       help=f"not ported (ROADMAP {_UNPORTED_ITEM})", **kwargs)


def _refuse_unported_flags(args) -> None:
    """Raise for a registered-but-unported flag of args.command that was
    given."""
    flags = {"run": _UNPORTED_RUN, "solve": _UNPORTED_SOLVE}.get(args.command, ())
    for flag, _ in flags:
        dest = flag.lstrip("-").replace("-", "_")
        if getattr(args, dest, None) is not None:
            raise NotImplementedError(
                f"`{flag}` is not ported (ROADMAP {_UNPORTED_ITEM})"
            )


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-k", "--kscaling", type=float, default=11.0,
                   help="distance scaling K (default 11)")
    p.add_argument("-a", "--alpha", type=float, default=0.5,
                   help="IF exponent alpha (default 0.5; published models used 1.1)")
    p.add_argument("-m", "--model-count", type=int, default=20,
                   help="models to build (default 20; top 5 kept by NOE energy)")
    p.add_argument("--fast", action="store_true",
                   help="reduced annealing schedule for smoke runs")
    p.add_argument("--turbo", action="store_true",
                   help="production speed preset: ~10x fewer steps")
    p.add_argument("--no-violation-reports", action="store_true",
                   help="skip the per-model violation report files")
    p.add_argument("--no-shard-large", action="store_true",
                   help="do not row-shard inputs beyond the largest length "
                        "bucket over the visible devices: solve them at their "
                        "exact length on one device")
    p.add_argument("--shard-quantum", type=int, default=512,
                   help="padding unit for beyond-the-bucket lengths (default 512)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to compute (default cuda, which fails without a "
                        "CUDA device; cpu runs the kernels' plain twins)")


def _add_alpha_ensemble(p: argparse.ArgumentParser) -> None:
    p.add_argument("--alpha-ensemble", default="",
                   help="comma-separated extra alpha values pooled into the "
                        "Spearman ranking (quality mode)")


def _make_config(args):
    from chromosome3d_tpu_torch.config import (
        AnnealConfig,
        PipelineConfig,
        RestraintConfig,
        fast_anneal,
        turbo_anneal,
    )

    anneal = AnnealConfig()
    if args.turbo:
        anneal = turbo_anneal(anneal)
    if args.fast:
        anneal = fast_anneal(anneal)
    alpha_ensemble = tuple(
        float(a) for a in (getattr(args, "alpha_ensemble", None) or "").split(",")
        if a.strip()
    )
    return PipelineConfig(
        model_count=args.model_count,
        restraints=RestraintConfig(kscaling=args.kscaling, alpha=args.alpha),
        anneal=anneal,
        alpha_ensemble=alpha_ensemble,
        emit_violation_reports=not args.no_violation_reports,
        shard_large=not args.no_shard_large,
        shard_quantum=args.shard_quantum,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="chromosome3d_tpu_torch",
        description="3D chromosome reconstruction from Hi-C IF matrices "
                    "(PyTorch / CUDA port)",
    )
    sub = parser.add_subparsers(dest="command")

    run = sub.add_parser("run", help="reconstruct one chromosome")
    run.add_argument("-i", "-if", "--input", required=True,
                     help="IF matrix: dense text, or a float .npy (the "
                          "at-scale format, loaded as a memmap)")
    run.add_argument("-o", "--output", required=True, help="output directory")
    _add_unported(run, _UNPORTED_RUN)
    _add_common(run)
    _add_alpha_ensemble(run)

    slv = sub.add_parser("solve", help="solve directly from a restraint file "
                                       "(.rr or CNS .tbl), no IF matrix required")
    slv.add_argument("-r", "--restraints", required=True,
                     help=".rr (i j lo hi conf) or CNS .tbl file")
    slv.add_argument("-o", "--output", required=True, help="output directory")
    slv.add_argument("-L", "--length", type=int, default=None,
                     help="bead count (default: largest residue index)")
    _add_common(slv)
    _add_unported(slv, _UNPORTED_SOLVE)

    gen = sub.add_parser("genome", help="whole-genome run, a launch a length bucket "
                                        "(replaces test.sh)")
    gen.add_argument("-i", "--input-dir", required=True,
                     help="directory of chr*_matrix.txt")
    gen.add_argument("-o", "--output-dir", required=True)
    gen.add_argument("--filter", default="",
                     help="substring filter on job names, e.g. 500kb")
    gen.add_argument("--resume", action="store_true",
                     help="skip chromosomes already in <output>/checkpoint")
    _add_common(gen)
    _add_alpha_ensemble(gen)

    sp = sub.add_parser("spearman", help="score models vs an IF matrix")
    sp.add_argument("matrix", help="IF matrix file")
    sp.add_argument("pdb", help="PDB file or directory of PDBs")
    sp.add_argument("range", nargs="?", type=int, default=3,
                    help="|i-j| short-range cutoff (default 3)")
    for name, item in _UNPORTED.items():
        sub.add_parser(name, help=f"not ported (ROADMAP {item})")

    args, extra = parser.parse_known_args(argv)
    if args.command in _UNPORTED:
        raise NotImplementedError(
            f"`{args.command}` is not ported (ROADMAP {_UNPORTED[args.command]})"
        )
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.command is None:
        parser.print_help()
        return 2
    _refuse_unported_flags(args)

    if args.command == "run":
        from chromosome3d_tpu_torch.pipeline import run_pipeline

        summary = run_pipeline(args.input, args.output, _make_config(args),
                               device=args.device)
        print(json.dumps(summary))
        return 0

    if args.command == "solve":
        from chromosome3d_tpu_torch.pipeline import run_restraints_pipeline

        summary = run_restraints_pipeline(args.restraints, args.output,
                                          _make_config(args), L=args.length,
                                          device=args.device)
        print(json.dumps(summary))
        return 0

    if args.command == "genome":
        from chromosome3d_tpu_torch.parallel.genome import discover_jobs, run_genome

        jobs = discover_jobs(args.input_dir)
        if args.filter:
            jobs = [j for j in jobs if args.filter in j.name]
        summaries = run_genome(args.input_dir, args.output_dir, _make_config(args),
                               jobs=jobs, resume=args.resume, device=args.device)
        print(json.dumps(summaries, indent=1))
        return 0

    if args.command == "spearman":
        from chromosome3d_tpu_torch.metrics import spearman_if_model
        from chromosome3d_tpu_torch.io import load_if_matrix, load_pdb_dir, read_ca_pdb

        matrix = load_if_matrix(args.matrix)
        paths = [args.pdb] if os.path.isfile(args.pdb) else load_pdb_dir(args.pdb)
        scores = {}
        for path in paths:
            coords = read_ca_pdb(path)
            if args.range >= len(coords):
                print("Spearman Correlation coefficient = -")
                return 0
            scores[path] = spearman_if_model(matrix, coords, args.range)
        print("SRCC\tPDB")
        for path in sorted(scores, key=lambda p: -scores[p]):
            print(f"{scores[path]:.3f}\t{path}")
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
