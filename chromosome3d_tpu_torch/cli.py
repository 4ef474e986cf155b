"""Command-line interface of the port: the subcommands of
chromosome3d_tpu.cli, with the flags the ported slices support.

  python -m chromosome3d_tpu_torch run -i <IF matrix> -o <outdir> [-k K] [-a ALPHA]
      [-m MODELS] [--fast | --turbo] [--no-violation-reports] [--alpha-ensemble A,B,..]
      [--no-shard-large] [--shard-quantum Q] [--device {cuda,cpu}] [--profile DIR]
      [--chrom NAME] [--resolution BP] [--bed BED] [--ice] [--norm NORM]
  python -m chromosome3d_tpu_torch solve -r <restraints (.rr or .tbl)> -o <outdir> [-L L]
      [-m MODELS] [--fast | --turbo] [--device {cuda,cpu}]
  python -m chromosome3d_tpu_torch genome -i <dir of chr*_matrix.txt> -o <outdir>
      [--filter SUBSTRING] [--resume] [-m MODELS] [--fast | --turbo]
      [--alpha-ensemble A,B,..] [--device {cuda,cpu}]
  python -m chromosome3d_tpu_torch coinit -i <low-res matrix> -p <high-res PDB> -o <outdir>
      [--factor F] [-m MODELS] [--fast | --turbo] [--device {cuda,cpu}]
  python -m chromosome3d_tpu_torch spearman <matrix> <pdb-or-dir> [range]
  python -m chromosome3d_tpu_torch assess <pdb-or-dir> <tbl> [--relax R]
  python -m chromosome3d_tpu_torch render <pdb or run dir> [-o PNG]
  python -m chromosome3d_tpu_torch similarity -o <genome output dir> [--factor F]
  python -m chromosome3d_tpu_torch serve --socket PATH [--turbo] [--device {cuda,cpu}]
  python -m chromosome3d_tpu_torch submit --socket PATH (-i <IF matrix> | -r <restraints>)
      -o <outdir> [-a ALPHA] [-m MODELS] [--turbo] | --ping | --shutdown
  python -m chromosome3d_tpu_torch calibrate [-L LxB,...] [--batch B] [--repeats N]
      [--steps S] [--out PATH] [--spread-gate G] [--force] [--verify] [--device {cuda,cpu}]

`run`, `solve`, `genome` and `coinit` compute on the first CUDA device (the
kernels build at first use) and fail when there is none; `--device cpu`
runs them on the CPU, with the kernels' plain twins, and is the only way
onto the CPU. `run` reads the dense text matrix, a float `.npy`, cooler
`.cool`/`.mcool` (needs h5py), juicer `.hic` (`--chrom`, `--resolution`,
`--norm`) and HiC-Pro `.matrix` (`--bed`, `--chrom`); `--ice` balances raw
counts; `--profile DIR` writes a torch.profiler trace of the solve. `genome`
solves every `chr*_<res>_matrix.txt` of a directory (those whose name holds
`--filter`), one length bucket at a time (parallel.genome), past the
largest length bucket too; `--resume` skips the chromosomes already in
`<outdir>/checkpoint`. `--alpha-ensemble` (on `run` and `genome`) solves
again for each extra alpha and pools the models into the Spearman ranking.
Past the largest length bucket with more than one CUDA device visible they
row-shard the solve over all of them by themselves where it would not fit
one (pipeline._use_sharded, genome.bucket_devices; `--no-shard-large` turns
that off, `--shard-quantum` sets the padding unit past the buckets).
`solve` takes an external restraint set: CONFOLD-style `.rr` rows `i j lo
hi conf` or a CNS NOE `.tbl`, `or`-group rows included. `coinit` solves a
low-resolution matrix started from a reduced high-resolution model
(similarity.solve_coinit); `similarity` writes the cross-resolution report
of a genome output tree; `assess` scores PDBs against a CNS `.tbl`;
`render` draws a model to PNG (needs matplotlib). `serve` runs the
warm-model server on a Unix socket (serve.serve; on the first CUDA device
unless `--device cpu`), and `submit` sends it one request (serve.request:
a matrix with `-i`, a restraint file with `-r`, or `--ping` /
`--shutdown`), importing neither torch nor the solver; it exits 1 when the
server answers ok: false and 2 on bad arguments, as the JAX CLI's does.
`calibrate` times the four step routes on the device (ops.calibrate; the
card unless `--device cpu`) and writes the dispatch table the solver's
route choice reads (`--out`, else CHROM3D_DISPATCH_TABLE, else
~/.cache/chromosome3d_torch/dispatch.json); `--verify` times the active
table's entries again and reports the drift, writing nothing; each prints
its JSON. `--alpha-ensemble` on `solve` and `coinit`, whose pipelines have
no alpha loop in the JAX package either, is refused with that reason.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# the JAX CLI registers --alpha-ensemble on these too and ignores it there
_NO_ALPHA_LOOP = ("solve", "coinit")


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
                     help="IF matrix: dense text, a float .npy (the at-scale "
                          "format, loaded as a memmap), .cool/.mcool, .hic, or "
                          "HiC-Pro .matrix")
    run.add_argument("-o", "--output", required=True, help="output directory")
    run.add_argument("--profile", default=None, metavar="DIR",
                     help="write a torch.profiler trace of the solve to DIR")
    run.add_argument("--chrom", default=None,
                     help="chromosome name (for .cool/.hic/.matrix inputs)")
    run.add_argument("--resolution", type=int, default=None,
                     help="bin size in bp (for .hic/.mcool inputs)")
    run.add_argument("--bed", default=None,
                     help="HiC-Pro .bed bin table (for .matrix inputs)")
    run.add_argument("--ice", action="store_true",
                     help="ICE-balance raw counts before restraint generation")
    run.add_argument("--norm", default="NONE",
                     help="apply a stored .hic normalization vector "
                          "(KR, VC, VC_SQRT, SCALE, ...; default NONE = raw)")
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

    ass = sub.add_parser(
        "assess",
        help="assess model PDB(s) against a CNS NOE tbl "
             "(count_satisfied / sum_dev, incl. or-group restraints)",
    )
    ass.add_argument("pdb", help="PDB file or directory of PDBs")
    ass.add_argument("tbl", help="contact.tbl (CNS NOE restraints)")
    ass.add_argument("--relax", type=float, default=0.5,
                     help="satisfaction window (default 0.5 A)")

    ren = sub.add_parser("render", help="render model PDB(s) to PNG (needs matplotlib)")
    ren.add_argument("target", help="a PDB file or a run output directory")
    ren.add_argument("-o", "--output", default=None, help="output PNG (file mode)")

    coi = sub.add_parser(
        "coinit",
        help="solve a LOW-resolution matrix co-initialized from a reduced "
             "HIGH-resolution model (cross-resolution consistency workflow)",
    )
    coi.add_argument("-i", "--input", required=True, help="low-res IF matrix")
    coi.add_argument("-p", "--hires-pdb", required=True,
                     help="high-resolution model PDB to seed from")
    coi.add_argument("-o", "--output", required=True)
    coi.add_argument("--factor", type=int, default=2,
                     help="hi-res -> lo-res bead reduction factor (default 2)")
    _add_common(coi)

    sim = sub.add_parser(
        "similarity",
        help="cross-resolution similarity report + reduced models "
             "(the output_models/similarity.txt protocol)",
    )
    sim.add_argument("-o", "--output-dir", required=True,
                     help="a run_genome output tree with chr*_{1mb,500kb} subdirs")
    sim.add_argument("--factor", type=int, default=2)

    srv = sub.add_parser(
        "serve",
        help="warm-model server on a Unix socket: keeps the built kernels and "
             "the device warm across requests",
    )
    srv.add_argument("--socket", required=True, help="unix socket path")
    srv.add_argument("--turbo", action="store_true")
    srv.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="where to compute (default cuda, which fails without a "
                          "CUDA device; cpu runs the kernels' plain twins)")

    cli = sub.add_parser("submit", help="send one solve request to a server")
    cli.add_argument("--socket", required=True)
    cli.add_argument("-i", "--input", help="IF matrix file")
    cli.add_argument("-r", "--restraints",
                     help="solve from a .rr / CNS .tbl restraint file instead")
    cli.add_argument("-o", "--output", help="output directory")
    cli.add_argument("-a", "--alpha", type=float, default=0.5)
    cli.add_argument("-m", "--model-count", type=int, default=10)
    cli.add_argument("--turbo", action="store_true")
    cli.add_argument("--ping", action="store_true")
    cli.add_argument("--shutdown", action="store_true")

    for p in (slv, coi):
        p.add_argument("--alpha-ensemble", default=None,
                       help="refused: this pipeline has no alpha loop")
    cal = sub.add_parser(
        "calibrate",
        help="measure the kernel-dispatch crossovers on this device and write the "
             "dispatch table the route choice reads (>= 5 repeats; replaces the "
             "frozen defaults)",
    )
    cal.add_argument("-L", "--lengths", default=None,
                     help="comma-separated cases: LxB pairs (e.g. 512x10,2048x4) or "
                          "bare bead counts (measured at --batch). Default: the "
                          "production shapes (512x10, 512x20, 1024x4, 2048x4, 4096x4)")
    cal.add_argument("--batch", type=int, default=4,
                     help="structure count for bare -L lengths (default 4)")
    cal.add_argument("--repeats", type=int, default=5)
    cal.add_argument("--steps", type=int, default=None,
                     help="steps a timed call (default 960)")
    cal.add_argument("--out", default=None,
                     help="table path (default CHROM3D_DISPATCH_TABLE or "
                          "~/.cache/chromosome3d_torch/dispatch.json)")
    cal.add_argument("--spread-gate", type=float, default=None,
                     help="reject cases whose repeat spread exceeds this (default "
                          "0.5); the previous entry stays in force")
    cal.add_argument("--force", action="store_true",
                     help="measure even on a loaded host (normally refused)")
    cal.add_argument("--verify", action="store_true",
                     help="time the active table's entries again and report the "
                          "drift; writes nothing")
    cal.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="where to measure (default cuda, which fails without a "
                          "CUDA device; cpu times the kernels' plain twins)")

    args, extra = parser.parse_known_args(argv)
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.command is None:
        parser.print_help()
        return 2
    if args.command in _NO_ALPHA_LOOP and args.alpha_ensemble is not None:
        raise NotImplementedError(
            f"`--alpha-ensemble` is not supported by `{args.command}`: the restraint "
            "pipeline has no alpha loop, in the JAX package either"
        )

    if args.command == "run":
        from chromosome3d_tpu_torch.pipeline import run_pipeline

        summary = run_pipeline(
            args.input, args.output, _make_config(args), device=args.device,
            profile_dir=args.profile, chrom=args.chrom, resolution=args.resolution,
            bed_path=args.bed, ice=args.ice, norm=args.norm,
        )
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

    if args.command == "assess":
        from chromosome3d_tpu_torch.assess import assess_pdb_vs_tbl
        from chromosome3d_tpu_torch.config import PipelineConfig
        from chromosome3d_tpu_torch.io import load_pdb_dir, read_ca_pdb

        cfg = PipelineConfig(dist_relax=args.relax)
        paths = [args.pdb] if os.path.isfile(args.pdb) else load_pdb_dir(args.pdb)
        print(f"NOE_SATISFIED(+-{args.relax}A)  SUM_OF_DEVIATIONS>=0.2  PDB")
        for path in paths:
            sat, total, dev = assess_pdb_vs_tbl(read_ca_pdb(path), args.tbl, cfg)
            print(f"{sat}/{total}             {dev:.2f}                {path}")
        return 0

    if args.command == "render":
        from chromosome3d_tpu_torch.render import render_model, render_run

        if os.path.isdir(args.target):
            for png in render_run(args.target):
                print(png)
        else:
            from chromosome3d_tpu_torch.io import read_ca_pdb

            out = args.output or args.target.replace(".pdb", ".png")
            print(render_model(read_ca_pdb(args.target), out))
        return 0

    if args.command == "coinit":
        from chromosome3d_tpu_torch.io import load_if_matrix, read_ca_pdb, write_ca_pdb
        from chromosome3d_tpu_torch.metrics import cross_resolution_similarity
        from chromosome3d_tpu_torch.similarity import solve_coinit

        cfg = _make_config(args)
        lo_m = load_if_matrix(args.input)
        hi = read_ca_pdb(args.hires_pdb)
        coords, order, scores = solve_coinit(lo_m, hi, cfg, factor=args.factor,
                                             device=args.device)
        os.makedirs(args.output, exist_ok=True)
        ident = os.path.basename(args.input)
        ident = ident[:-4] if ident.endswith(".txt") else ident
        atag = f"a{cfg.restraints.alpha}".replace(".", "")
        for rank, idx in enumerate(order, start=1):
            write_ca_pdb(
                os.path.join(args.output, f"{ident}_rank{rank:02d}_{atag}.pdb"),
                coords[idx],
                remarks={"spearman_if_inv_d": float(scores[idx])},
            )
        best = coords[order[0]]
        rho, rmsd = cross_resolution_similarity(hi, best, args.factor)
        print(json.dumps({
            "best_spearman_if_inv_d": float(scores[order[0]]),
            "cross_res_spearman": rho,
            "cross_res_rmsd": rmsd,
            "models": int(len(coords)),
        }))
        return 0

    if args.command == "similarity":
        from chromosome3d_tpu_torch.similarity import (
            pair_outputs_by_chromosome,
            similarity_report,
            write_reduced_model,
        )

        pairs = pair_outputs_by_chromosome(args.output_dir)
        if not pairs:
            print("no chromosome pairs with both resolutions found", file=sys.stderr)
            return 1
        for hi, _ in pairs.values():
            write_reduced_model(hi, factor=args.factor)
        out = f"{args.output_dir}/similarity.txt"
        results = similarity_report(pairs, out, args.factor)
        for name, (rho, rmsd) in results.items():
            print(f"{name}: spearman={rho:.4f} rmsd={rmsd:.3f}")
        print(f"wrote {out}")
        return 0

    if args.command == "serve":
        from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, turbo_anneal
        from chromosome3d_tpu_torch.serve import serve

        anneal = AnnealConfig()
        if args.turbo:
            anneal = turbo_anneal(anneal)
        serve(args.socket, PipelineConfig(anneal=anneal), device=args.device)
        return 0

    if args.command == "calibrate":
        from chromosome3d_tpu_torch.ops.calibrate import (
            DEFAULT_SPREAD_GATE,
            DEFAULT_STEPS,
            calibrate_dispatch,
            verify_dispatch,
        )

        if args.verify:
            report = verify_dispatch(repeats=min(args.repeats, 3), force=args.force,
                                     device=args.device)
            print(json.dumps(report, indent=1))
            return 0
        cases = None
        if args.lengths:
            cases = []
            for tok in args.lengths.split(","):
                tok = tok.strip()
                if not tok:
                    continue
                if "x" in tok:
                    L, B = tok.split("x", 1)
                    cases.append((int(L), int(B)))
                else:
                    cases.append((int(tok), args.batch))
        table = calibrate_dispatch(
            cases=cases, repeats=args.repeats, out_path=args.out,
            steps=DEFAULT_STEPS if args.steps is None else args.steps,
            spread_gate=(DEFAULT_SPREAD_GATE if args.spread_gate is None
                         else args.spread_gate),
            force=args.force, device=args.device,
        )
        print(json.dumps(table, indent=1))
        return 0

    if args.command == "submit":
        from chromosome3d_tpu_torch.serve import request

        if args.ping:
            print(json.dumps(request(args.socket, {"cmd": "ping"})))
            return 0
        if args.shutdown:
            print(json.dumps(request(args.socket, {"cmd": "shutdown"})))
            return 0
        if args.restraints and args.input:
            print("submit takes -i OR -r, not both", file=sys.stderr)
            return 2
        if args.restraints and args.output:
            resp = request(
                args.socket,
                {
                    "restraints": args.restraints,
                    "out": args.output,
                    "models": args.model_count,
                    "turbo": args.turbo,
                },
            )
            print(json.dumps(resp))
            return 0 if resp.get("ok") else 1
        if not (args.input and args.output):
            print("submit needs -i or -r, and -o (or --ping/--shutdown)",
                  file=sys.stderr)
            return 2
        resp = request(
            args.socket,
            {
                "matrix": args.input,
                "out": args.output,
                "alpha": args.alpha,
                "models": args.model_count,
                "turbo": args.turbo,
            },
        )
        print(json.dumps(resp))
        return 0 if resp.get("ok") else 1

    return 2


if __name__ == "__main__":
    sys.exit(main())
