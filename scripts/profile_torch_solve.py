"""Profile the PyTorch port's ensemble solve on an NVIDIA GPU.

    python3 scripts/profile_torch_solve.py [--length 4985] [--models 10]
    python3 scripts/profile_torch_solve.py --restraints <file.rr|file.tbl> [--models 10]
    python3 scripts/profile_torch_solve.py --shards 4 [...]   # the row-sharded solver
    python3 scripts/profile_torch_solve.py --genome [--models 10]   # a genome bucket

Builds a ground-truth chromosome (`confined_walk(length, seed=7)`, IF noise
0.1), its exact restraints with the on-card prep padded to the length's
bucket (a length bucket, or a 512-multiple past them) — or, with
--restraints, the tensors `solve` builds from a restraint file (windows,
confidences, or-groups, the two-sided init when the file has windows) —
then times the prep, the init (landmark MDS from L = 2048, classical MDS
below), two warm solves with a CUDA synchronise, and one more solve under
torch.profiler. Prints the solve's wall seconds, its device seconds, the
card's busy share, the device time of the top kernels, and the card's
`nvidia-smi` name and power limit. The default is chip_smoke.py's at-scale
shape (L = 4985 -> 5120, 10 models, the default 2,760-step schedule). With
--shards N the same tensors are cut into N row strips on N copies of the
card and go through `solve_ensemble_sharded` (its own landmark start), so
the one card's busy share on the sharded route can be read. With --phases
(one device) one more warm solve is split, with a CUDA synchronise at every
boundary, into the init, the hot loop, the pick, the cool and final loop,
the final energy terms and the rest. With --genome the solve is the genome
runner's bucket solve (`parallel.genome.solve_bucket`) on chip_smoke.py's
45 inputs (the reference genome's lengths 35..455, one 512 bucket): the
mds_init loop over the chromosomes is timed on its own, then two warm
bucket solves and a profiled one.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chromosome3d_tpu_torch import pipeline  # noqa: E402
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig  # noqa: E402
from chromosome3d_tpu_torch.ops.device_prep import exact_tiles_from_if_device  # noqa: E402
from chromosome3d_tpu_torch.ops.energy import (  # noqa: E402
    auto_weight_exponent,
    dense_or_groups_from_numpy,
)
from chromosome3d_tpu_torch.pipeline import _bucket_pad  # noqa: E402
from chromosome3d_tpu_torch.restraints import read_contact_tbl_full, read_rr  # noqa: E402
from chromosome3d_tpu_torch.parallel.shards import ShardGroup  # noqa: E402
from chromosome3d_tpu_torch.solver import sharded  # noqa: E402
from chromosome3d_tpu_torch.solver.anneal import solve_ensemble_impl  # noqa: E402
from chromosome3d_tpu_torch.solver.init import landmark_init, mds_init  # noqa: E402
from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def file_inputs(path, dev):
    """The restraint tensors, config and or-groups `solve` builds from a
    restraint file: (L, L_pad, restraints, AnnealConfig, or_groups)."""
    cfg = PipelineConfig()
    og = conf = None
    if path.endswith(".tbl"):
        r, og_np = read_contact_tbl_full(path)
        og = None if og_np is None else dense_or_groups_from_numpy(og_np, dev)
    else:
        r, conf = read_rr(path, None, cfg.restraints)
    cfg = pipeline.auto_exact(cfg, r)
    an = cfg.anneal
    if r.negdev.any() or r.posdev.any():
        an = dataclasses.replace(an, embed_two_sided=True)
    L_pad, _ = _bucket_pad(r.length, cfg)
    dense = pipeline._fold_conf(pipeline._padded_dense(
        r, cfg.restraints, L_pad, pipeline._exact_provable(cfg), dev), conf)
    return r.length, L_pad, dense, an, og


def solve_phases(solve):
    """Seconds of one solve by phase: the solver's init, pick and final-terms
    calls are wrapped with a synchronise on both sides; the hot loop is what
    lies between the init and the pick, the cool (and final) loop between
    the pick and the terms."""
    from chromosome3d_tpu_torch.solver import anneal

    marks = []
    names = ("mds_init", "landmark_init", "pair_energy_and_grad_batched", "energy_terms")
    real = {n: getattr(anneal, n) for n in names}

    def wrap(name):
        def fn(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*args, **kwargs)
            torch.cuda.synchronize()
            marks.append((name, t0, time.perf_counter()))
            return out
        return fn

    for n in names:
        setattr(anneal, n, wrap(n))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(3)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        for n, fn in real.items():
            setattr(anneal, n, fn)
    if [m[0] for m in marks][1:] != ["pair_energy_and_grad_batched", "energy_terms"]:
        raise SystemExit(f"--phases: unexpected calls {[m[0] for m in marks]}")
    (_, i0, i1), (_, p0, p1), (_, e0, e1) = marks
    return {"before_init": i0 - t0, "init": i1 - i0, "hot_loop": p0 - i1, "pick": p1 - p0,
            "cool_loop": e0 - p1, "final_terms": e1 - e0, "rest": t1 - e1, "total": t1 - t0}


def report(prof, wall):
    """The profiled solve's device seconds, busy share and top kernels, B1's
    launches so far and the card's name and power limit."""
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    print(f"profiled solve: wall {wall:.4f} s, device {total / 1e6:.4f} s, "
          f"busy share {total / 1e6 / wall:.4f}")
    for key, us, n in rows[:15]:
        print(f"  {us / 1e3:10.3f} ms {100 * us / total:6.2f}% x{n:6d}  {key[:90]}")
    # kernel B1 is one launch a phase: its rows above are fused_steps_kernel<columns a
    # lane, rows a warp, resident>, the hot phase's and the rest's
    from chromosome3d_tpu_torch.ops.fused_step import fused_steps_batched
    print(f"B1 (fused_steps_kernel) since the start: {fused_steps_batched.launches} "
          f"launches, {fused_steps_batched.steps} steps")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())


def profile_genome(models: int, dev) -> int:
    """The genome bucket solve on chip_smoke.py's 45 inputs."""
    import tempfile

    from chip_smoke import write_genome_inputs
    from chromosome3d_tpu_torch.parallel import genome
    from chromosome3d_tpu_torch.solver.anneal import _chromosome

    cfg = PipelineConfig(model_count=models)
    with tempfile.TemporaryDirectory() as tmp:
        write_genome_inputs(tmp)
        buckets = genome.bucket_jobs(genome.discover_jobs(tmp), cfg.length_buckets)
        (L_pad, jobs), = buckets.items()
        t0 = time.perf_counter()
        batched, masks, _, raw = genome._stack_bucket(jobs, L_pad, cfg)
        load_s = time.perf_counter() - t0
    cfg = pipeline.auto_exact(cfg, raw[0])
    an = cfg.anneal
    ex = type(batched)(*(torch.tensor(getattr(batched, f.name), device=dev)
                         for f in dataclasses.fields(batched)))
    bms = torch.tensor(masks, device=dev)
    init_s = [timed(lambda: [mds_init(_chromosome(ex, c), bond_length=an.bond_length,
                                      bead_mask=bms[c]) for c in range(len(jobs))])[1]
              for _ in range(2)]

    def solve(seed):
        return genome.solve_bucket(batched, masks, cfg, base_seed=seed, device=dev)

    solve_s = [timed(lambda: solve(i))[1] for i in range(2)]
    print(f"genome bucket L={L_pad}: {len(jobs)} chromosomes, {models} models, "
          f"{an.total_steps} steps: host stacking {load_s:.4f} s; the mds_init loop "
          f"{init_s[0]:.4f} s cold, {init_s[1]:.4f} s warm; warm bucket solves (upload "
          f"included) {solve_s[0]:.4f} s, {solve_s[1]:.4f} s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: solve(9))
    report(prof, wall)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--length", type=int, default=4985)
    ap.add_argument("--models", type=int, default=10)
    ap.add_argument("--restraints", default=None,
                    help="profile `solve` on this .rr or .tbl file instead")
    ap.add_argument("--shards", type=int, default=1,
                    help="row-shard the solve over this many copies of the card")
    ap.add_argument("--phases", action="store_true",
                    help="split one more warm solve into its phases (one device)")
    ap.add_argument("--genome", action="store_true",
                    help="profile the genome bucket solve on chip_smoke.py's 45 inputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_solve: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    if args.genome:
        return profile_genome(args.models, dev)
    og = None
    if args.restraints:
        (L, L_pad, ex, cfg, og), prep_s = timed(lambda: file_inputs(args.restraints, dev))
    else:
        L = args.length
        L_pad, _ = _bucket_pad(L, PipelineConfig())
        X = confined_walk(L, seed=7)
        M = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=7).astype(np.float32)
        rc = RestraintConfig(kscaling=11.0, alpha=0.5)
        ex, prep_s = timed(lambda: exact_tiles_from_if_device(
            M, L_pad, rc, rc.weighting, auto_weight_exponent(L), device=dev))
        cfg = AnnealConfig(exact_restraints=True)
    bm = torch.zeros(L_pad, device=dev)
    bm[:L] = 1.0
    init = landmark_init if L_pad >= 2048 else mds_init
    init_s = [timed(lambda: init(ex, bond_length=cfg.bond_length, bead_mask=bm,
                                 two_sided=cfg.embed_two_sided))[1]
              for _ in range(2)]
    if args.shards > 1:
        group = ShardGroup([dev] * args.shards)
        strips = sharded.restraint_strips(group, ex)

        def solve(seed):
            return sharded.solve_ensemble_sharded(
                group, strips, cfg, args.models, bm, or_groups=og,
                generator=torch.Generator().manual_seed(seed))
    else:
        def solve(seed):
            return solve_ensemble_impl(
                ex, cfg, args.models, bm, generator=torch.Generator().manual_seed(seed),
                or_groups=og)
    solve_s = [timed(lambda: solve(i))[1] for i in range(2)]
    print(f"L={L}->{L_pad}, {args.models} models, {cfg.total_steps} steps, "
          f"two-sided {cfg.embed_two_sided}, exact {cfg.exact_restraints}, or-groups "
          f"{0 if og is None else og.lo.shape[0]}, {args.shards} shard(s): prep "
          f"{prep_s:.4f} s (first call); {init.__name__} {init_s[0]:.4f} s cold, "
          f"{init_s[1]:.4f} s warm; warm solves {solve_s[0]:.4f} s, {solve_s[1]:.4f} s")
    if args.phases and args.shards == 1:
        for _ in range(2):
            ph = solve_phases(solve)
            print("solve by phase (s, synchronised at every boundary): "
                  + ", ".join(f"{k} {v:.5f}" for k, v in ph.items()))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: solve(9))
    report(prof, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
