"""Whole-genome runs on one GPU — the port of chromosome3d_tpu/parallel/genome.py.

The reference runs a genome as test.sh's 46 backgrounded processes (23
chromosomes x 2 resolutions, test.sh:4-11). Here, as in the JAX package,
the genome is a handful of launches:

  1. chromosomes are bucketed by padded bead count (length_buckets in
     PipelineConfig) — padding beads are masked out of every energy term;
  2. each bucket's restraints are stacked on the host as (C, L, L) tensors
     and (C, L) bead masks, each chromosome's weights normalised over its
     own restraints before padding (`_stack_bucket`);
  3. the bucket is solved together on one device (`solve_bucket`,
     solver.anneal.solve_bucket_impl): the JAX package's
     vmap(solve_ensemble_impl) over the bucket's chromosomes becomes one
     batch of C x 2 x models structures with a tile set per chromosome, so
     kernel B1 runs each phase of the schedule for the whole bucket in one
     launch and kernel B2 the enantiomer pick in one;
  4. each chromosome is assessed and its artifacts written on host threads
     (pipeline.emit_artifacts), and checkpointed (utils.checkpoint), so a
     run can resume.

Not ported, and refused with NotImplementedError: buckets past the largest
length bucket (the JAX package's chrom x beads sharded genome solver,
ROADMAP A12) and the alpha ensemble (A11). The JAX package's
multi-device mesh and its 2-D chrom x model layout have no counterpart: one
device solves a bucket.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from chromosome3d_tpu_torch.config import PipelineConfig
from chromosome3d_tpu_torch.device import resolve_device
from chromosome3d_tpu_torch.io.matrix import load_if_matrix, matrix_length
from chromosome3d_tpu_torch.ops.energy import (
    auto_weight_exponent,
    dense_restraints_from_numpy,
    exact_restraints_from_numpy,
)
from chromosome3d_tpu_torch.pipeline import auto_exact, emit_artifacts, quantum_bucket
from chromosome3d_tpu_torch.restraints import build_restraints
from chromosome3d_tpu_torch.solver.anneal import AnnealResult, solve_bucket_impl
from chromosome3d_tpu_torch.utils.checkpoint import GenomeCheckpoint
from chromosome3d_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class GenomeJob:
    """One chromosome x resolution work item."""

    name: str              # e.g. "chr21_500kb"
    path: str              # IF matrix file
    length: int = 0        # true bead count (filled by bucket_jobs)
    bucket: int = 0        # padded length


def discover_jobs(input_dir: str, pattern: str = r"chr(\w+)_(\w+)_matrix\.txt$") -> List[GenomeJob]:
    """Find chr*_{res}_matrix.txt inputs (the test.sh file layout)."""
    jobs = []
    rx = re.compile(pattern)
    for name in sorted(os.listdir(input_dir)):
        if rx.search(name):
            jobs.append(GenomeJob(name=name.replace("_matrix.txt", ""),
                                  path=os.path.join(input_dir, name)))
    return jobs


def bucket_jobs(
    jobs: Sequence[GenomeJob],
    buckets: Sequence[int],
    shard_quantum: Optional[int] = None,
) -> Dict[int, List[GenomeJob]]:
    """Assign each job the smallest bucket >= its bead count.

    Jobs beyond the largest bucket get a bucket rounded up to shard_quantum
    (the at-scale group, which run_genome refuses); with shard_quantum=None
    they raise (PipelineConfig.shard_large=False)."""
    out: Dict[int, List[GenomeJob]] = {}
    for job in jobs:
        if not job.length:
            job.length = matrix_length(job.path)
        fit = [b for b in buckets if b >= job.length]
        if fit:
            job.bucket = min(fit)
        elif shard_quantum:
            job.bucket = quantum_bucket(job.length, shard_quantum)
        else:
            raise ValueError(
                f"{job.name}: L={job.length} exceeds the largest bucket {max(buckets)}"
            )
        out.setdefault(job.bucket, []).append(job)
    return out


def _stack_bucket(jobs: Sequence[GenomeJob], L_pad: int, cfg: PipelineConfig):
    """Load and pad one bucket on the host: (restraints of (C, L, L) numpy
    arrays, (C, L) bead masks, the raw IF matrices, the unpadded Restraints
    for the assessment) — the JAX package's _stack_bucket(..., as_numpy=True).

    The per-chromosome weight normalisation (mean 1 over the real
    restraints, the exponent from the true length) happens BEFORE padding,
    so the padded batch is numerically identical to solving each chromosome
    alone. Restraints that are all exact (matrix-derived ones are) take the
    two-tensor form."""
    rc = cfg.restraints
    masks, matrices, raw = [], [], []
    for job in jobs:
        m = load_if_matrix(job.path)
        matrices.append(m)
        raw.append(build_restraints(m, rc))
        bead = np.zeros(L_pad, dtype=np.float32)
        bead[: m.shape[0]] = 1.0
        masks.append(bead)
    exact = cfg.anneal.noe_rswitch >= 1e8 and all(
        not r.negdev.any() and not r.posdev.any() for r in raw
    )
    builder = exact_restraints_from_numpy if exact else dense_restraints_from_numpy
    denses = []
    for r in raw:
        p = rc.weight_exponent
        if p is None:
            p = auto_weight_exponent(r.length)
        denses.append(builder(r.padded(L_pad), rc.weighting, p, as_numpy=True))
    batched = type(denses[0])(*(np.stack([getattr(d, f.name) for d in denses])
                                for f in dataclasses.fields(denses[0])))
    return batched, np.stack(masks), matrices, raw


def solve_bucket(batched, bead_masks, cfg: PipelineConfig, base_seed: Optional[int] = None,
                 device=None) -> AnnealResult:
    """Solve one bucket on `device` (device.resolve_device: None is the
    first CUDA device, and raises without one): batched holds (C, L, L)
    host arrays (from _stack_bucket) or tensors, bead_masks (C, L).
    Chromosome c draws from solver.anneal.chromosome_generator(base_seed,
    c), base_seed defaulting to cfg.seed. Returns an AnnealResult with a
    leading chromosome axis (coords (C, models, L, 3), energies (C, models),
    history (C, models, T))."""
    dev = resolve_device(device)
    restraints = type(batched)(*(
        torch.as_tensor(getattr(batched, f.name), dtype=torch.float32).to(dev).contiguous()
        for f in dataclasses.fields(batched)))
    masks = torch.as_tensor(bead_masks, dtype=torch.float32).to(dev)
    return solve_bucket_impl(restraints, cfg.anneal, cfg.model_count, masks,
                             base_seed=cfg.seed if base_seed is None else base_seed)


def run_genome(
    input_dir: str,
    output_dir: str,
    cfg: Optional[PipelineConfig] = None,
    jobs: Optional[List[GenomeJob]] = None,
    resume: bool = False,
    device=None,
) -> Dict[str, Dict]:
    """The test.sh equivalent on one device (device.resolve_device: None is
    the first CUDA device, and raises without one; "cpu" runs the kernels'
    plain twins): every chr*_matrix.txt in input_dir (or `jobs`) is solved
    bucket by bucket and assessed; per-chromosome artifacts land in
    output_dir/<name>/, each chromosome's result in output_dir/checkpoint/.

    resume=True skips chromosomes already in the checkpoint store; the
    returned dict covers every job all the same (finished ones from the
    store). Writes <output_dir>/summary.json: the per-chromosome summaries,
    a per-bucket phase breakdown in seconds (load / solve and download /
    extra alphas / emit) and the wall seconds."""
    cfg = cfg or PipelineConfig()
    dev = resolve_device(device)
    if cfg.alpha_ensemble:
        raise NotImplementedError("the alpha ensemble is not ported (ROADMAP A11)")
    t_genome0 = time.time()
    jobs = jobs if jobs is not None else discover_jobs(input_dir)
    if not jobs:
        raise FileNotFoundError(f"no chr*_matrix.txt inputs under {input_dir}")
    summaries: Dict[str, Dict] = {}
    phases: Dict[str, Dict] = {}

    def _write_summary():
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "summary.json"), "w") as f:
            json.dump({"chromosomes": summaries, "phases": phases,
                       "wall_seconds": round(time.time() - t_genome0, 2)}, f, indent=1)

    ckpt = GenomeCheckpoint(output_dir)
    if resume:
        done = [j for j in jobs if ckpt.has(j.name)]
        if done:
            log.info(f"resume: skipping {len(done)} finished chromosomes")
        jobs = [j for j in jobs if not ckpt.has(j.name)]
        summaries.update({d.name: ckpt.load(d.name)[2] for d in done})
        if not jobs:
            _write_summary()
            return summaries
    buckets = bucket_jobs(
        jobs, cfg.length_buckets, cfg.shard_quantum if cfg.shard_large else None
    )
    max_bucket = max(cfg.length_buckets)
    large = sorted(L for L in buckets if L > max_bucket)
    if large:
        names = [j.name for L in large for j in buckets[L]]
        raise NotImplementedError(
            f"{', '.join(names)}: past the largest length bucket {max_bucket} "
            f"(bucket L={', '.join(map(str, large))}) a genome run needs the chrom x "
            "beads sharded genome solver, not ported (ROADMAP A12)"
        )
    for L_pad, bucket in sorted(buckets.items()):
        ph = phases[f"L{L_pad}"] = {"chromosomes": [j.name for j in bucket]}
        t_ph = [time.time()]

        def _phase(name):
            # close the running phase segment and start the next
            now = time.time()
            ph[name] = round(ph.get(name, 0.0) + (now - t_ph[0]), 2)
            t_ph[0] = now

        log.info(f"bucket L={L_pad}: {len(bucket)} chromosomes "
                 f"({', '.join(j.name for j in bucket)}) on {dev}")
        batched, bead_masks, matrices, raw = _stack_bucket(bucket, L_pad, cfg)
        cfg_b = cfg
        if all(not r.negdev.any() and not r.posdev.any() for r in raw):
            cfg_b = auto_exact(cfg, raw[0])
        _phase("load_s")
        result = solve_bucket(batched, bead_masks, cfg_b, device=dev)
        coords = result.coords.cpu().numpy()   # synchronises
        energies_all = {k: v.cpu().numpy() for k, v in result.energies.items()}
        _phase("solve_and_views_s")
        alphas = [cfg.restraints.alpha] * coords.shape[1]
        _phase("alpha_s")   # the alpha ensemble is refused above

        def emit_one(b, job):
            """Assessment and artifact emission for one chromosome: host
            work only (numpy, file I/O), so chromosomes emit on host threads
            at once."""
            L = job.length
            out = os.path.join(output_dir, job.name)
            os.makedirs(out, exist_ok=True)
            c = coords[b, :, :L, :]
            energies = {k: v[b] for k, v in energies_all.items()}
            dense_b = dense_restraints_from_numpy(
                raw[b], cfg.restraints.weighting, cfg.restraints.weight_exponent,
                as_numpy=True,
            )
            summary = emit_artifacts(out, job.name, c, energies, matrices[b], raw[b],
                                     dense_b, cfg, alphas=alphas)
            summary["bucket"] = L_pad
            ckpt.save(job.name, c, energies, summary)
            log.info(f"  {job.name}: best Spearman(IF,1/d) = "
                     f"{summary['best_spearman_if_inv_d']:.4f}")
            return job.name, summary

        workers = min(8, os.cpu_count() or 1, len(bucket))
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for name, summary in pool.map(emit_one, range(len(bucket)), bucket):
                    summaries[name] = summary
        else:
            for b, job in enumerate(bucket):
                name, summary = emit_one(b, job)
                summaries[name] = summary
        _phase("emit_s")
    _write_summary()
    return summaries
