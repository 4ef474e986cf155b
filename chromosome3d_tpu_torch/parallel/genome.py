"""Whole-genome runs on one GPU — the port of chromosome3d_tpu/parallel/genome.py.

The reference runs a genome as test.sh's 46 backgrounded processes (23
chromosomes x 2 resolutions, test.sh:4-11). Here, as in the JAX package,
the genome is a handful of launches:

  1. chromosomes are bucketed by padded bead count (length_buckets in
     PipelineConfig; past the largest, a multiple of shard_quantum) —
     padding beads are masked out of every energy term;
  2. a bucket within the length buckets is stacked on the host as (C, L, L)
     tensors and (C, L) bead masks, each chromosome's weights normalised
     over its own restraints before padding (`_stack_bucket`), and solved
     together on one device (`solve_bucket`, solver.anneal.solve_bucket_impl):
     the JAX package's vmap(solve_ensemble_impl) over the bucket becomes one
     batch of C x 2 x models structures with a tile set per chromosome, so
     on every route the dispatch can choose, kernel B1 runs each phase of
     the schedule for the whole bucket in one launch (or B3 or B5, then B4,
     one launch each a step; on the unfused route B2, B3 or B5 once a
     step, a noise stream a chromosome) and kernel B2, B3 or B5 the
     enantiomer pick in one;
  3. a bucket past the length buckets with exact restraints (the default)
     skips the host prep: its IF matrices are padded and stacked once on the
     host (`bucket_stack`), their exact tiles built on the device
     (`bucket_tiles_from_if`, ops.device_prep), and the bucket solved by the
     chrom x beads genome solver (`solve_bucket_sharded_from_if`,
     solver.sharded.solve_genome_sharded): on the one device, every step
     the route's pair kernel (B6, or B2' where B6's strip tiles do not pay)
     once and kernel B4 once for the whole bucket. The assessment views are
     downloaded from the live tiles; under pair_bf16 the solve's tiles are
     stored bf16, so they are freed first and the bucket is prepped again
     at float32 from the same pad/stack for the views. Past the length
     buckets with windowed restraints (noe_rswitch < 1e8) the bucket is
     stacked on the host as within them and solved by `solve_bucket` on the
     one device, the JAX package's one-device route (B5 and B4 once a step
     for the bucket), or by `solve_bucket_sharded` (B5' on each rank's
     strips). Either kind
     spreads over the visible cards (`bucket_devices`) only where it would
     not fit the one device (`bucket_peak_bytes`);
  4. each chromosome is assessed and its artifacts written on host threads
     (pipeline.emit_artifacts), and checkpointed (utils.checkpoint), so a
     run can resume.

The alpha ensemble (cfg.alpha_ensemble) solves each bucket again per extra
alpha and pools the models into the Spearman ranking, as the JAX package
does. Every route a bucket past the length buckets can take runs with a
chromosome axis: the strip route (B6 + B4), the row-block route (B2' or B5'
+ B4) and the unfused route (B2' or B5', then solver.unfused's update with
a noise stream a chromosome).

Given a device list (`run_genome(devices=...)`, the JAX runner's mesh=;
`make_mesh`), a bucket within the length buckets takes the JAX package's
2-D chrom x model layout (`solve_bucket(devices=...)`, `model_axis_shards`):
where devices outnumber chromosomes each chromosome's models split over
replicas with generators of their own, and each device solves its block of
replicas as one stack, the blocks one after another from the host; a bucket
past them takes the chrom x beads solvers over the list. Without a list the
one-device rule above holds, so the models do not depend on the card count.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from chromosome3d_tpu_torch import device as device_mod
from chromosome3d_tpu_torch import pipeline
from chromosome3d_tpu_torch.config import PipelineConfig
from chromosome3d_tpu_torch.device import resolve_device
from chromosome3d_tpu_torch.io.matrix import load_if_matrix, matrix_length
from chromosome3d_tpu_torch.ops import device_prep, general_pair, strip_tri
from chromosome3d_tpu_torch.ops.energy import (
    ExactRestraints,
    auto_weight_exponent,
    dense_restraints_from_numpy,
    exact_restraints_from_numpy,
)
from chromosome3d_tpu_torch.parallel.shards import chrom_groups
from chromosome3d_tpu_torch.pipeline import (
    _exact_provable,
    auto_exact,
    auto_exact_matrix,
    emit_artifacts,
    quantum_bucket,
)
from chromosome3d_tpu_torch.restraints import build_restraints, restraints_from_exact_target
from chromosome3d_tpu_torch.solver import anneal
from chromosome3d_tpu_torch.solver.anneal import AnnealResult, solve_bucket_impl
from chromosome3d_tpu_torch.solver.sharded import solve_genome_sharded
from chromosome3d_tpu_torch.utils import trace
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
    (the at-scale buckets); with shard_quantum=None they raise
    (PipelineConfig.shard_large=False)."""
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


def make_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices a bucket is laid out over, the JAX package's 1-D `chrom`
    mesh as a list: `devices` (a list may name one device several times), or
    every visible CUDA device (device.shard_devices) when None. An empty
    list raises RuntimeError: nothing falls back to the CPU."""
    devs = device_mod.shard_devices() if devices is None else [torch.device(d) for d in devices]
    if not devs:
        raise RuntimeError("make_mesh: no devices to lay a bucket out over (no CUDA device "
                           "is visible and no list was given)")
    return devs


def model_axis_shards(B: int, n_dev: int, model_count: int) -> int:
    """The 2-D `chrom x model` layout decision: when devices outnumber the
    bucket's chromosomes, split each chromosome's restart budget over m
    replicas (batch entries with generators of their own) so every device
    works. Returns the largest divisor m of model_count with B * m <= n_dev
    (1 = the plain 1-D chrom layout)."""
    best = 1
    for m in range(2, model_count + 1):
        if model_count % m == 0 and B * m <= n_dev:
            best = m
    return best


def _upload(batched, rows, dev):
    """Entries `rows` of (C, L, L) host arrays or tensors as float32
    tensors on dev."""
    return type(batched)(*(
        trace.to_device(torch.as_tensor(getattr(batched, f.name)[rows], dtype=torch.float32),
                        dev).contiguous()
        for f in dataclasses.fields(batched)))


@trace.spanned("request")
def solve_bucket(batched, bead_masks, cfg: PipelineConfig, base_seed: Optional[int] = None,
                 device=None, devices: Optional[Sequence] = None,
                 model_shards: Optional[int] = None, xs: Optional[torch.Tensor] = None,
                 noise_seeds=None) -> AnnealResult:
    """Solve one bucket: batched holds (C, L, L) host arrays (from
    _stack_bucket) or tensors, bead_masks (C, L). Returns an AnnealResult
    with a leading chromosome axis (coords (C, models, L, 3), energies (C,
    models), history (C, models, T), pick (C, models)).

    The bucket is laid out over `devices` (make_mesh; one device may stand
    several times), or over [device] when devices is None
    (device.resolve_device: None is the first CUDA device, and raises
    without one): the JAX package's chrom x model layout over its `chrom`
    mesh. Each chromosome is split into m = model_shards (default
    model_axis_shards(C, len(devices), cfg.model_count), 1 on one device)
    replicas of model_count / m models; replica r = c m + j draws from
    solver.anneal.chromosome_generator(base_seed, r), base_seed defaulting
    to cfg.seed, as the JAX replica draws from split(PRNGKey(base_seed),
    B_pad)[r]; xs (C m, 2 x models / m, L, 3) and noise_seeds (C m,) replay
    given draws instead. The C m replicas, padded to B_pad, a multiple of
    the device count, are cut in order into one block a device; each device
    solves its block as one solve_bucket_impl with its replicas' tiles
    copied there, the blocks one after another from the host. The JAX
    runner's padding entries (copies of entry 0, discarded) are not solved.
    The replicas of a chromosome on one device share its init unless
    cfg.init is "random" (the one init that draws). At m = 1 on one device
    this is one solve_bucket_impl of the whole bucket, chromosome c drawing
    from chromosome_generator(base_seed, c).
    The results are gathered on devices[0] and folded back replica-major:
    replica j's models are models [j n, (j + 1) n), n = model_count / m,
    its pick offset by 2 j n."""
    seed = cfg.seed if base_seed is None else base_seed
    devices = [resolve_device(device)] if devices is None else make_mesh(devices)
    n_dev = len(devices)
    C = len(bead_masks)
    m = model_axis_shards(C, n_dev, cfg.model_count) if model_shards is None else model_shards
    if cfg.model_count % m:
        raise ValueError(f"model_shards={m} must divide model_count={cfg.model_count}")
    per = cfg.model_count // m
    if m > 1:
        log.info(f"2-D layout: {C} chromosomes x {m} model shards ({per} models each) "
                 f"over {n_dev} devices")
    B_eff = C * m
    for name, a in (("xs", xs), ("noise_seeds", noise_seeds)):
        if a is not None and len(a) != B_eff:
            raise ValueError(f"{name}: {len(a)} replicas, expected {B_eff} "
                             f"({C} chromosomes x {m})")
    blk = -(-B_eff // n_dev)            # B_pad / n_dev
    an = cfg.anneal
    inits, parts = {}, []
    for k, dev in enumerate(devices):
        reps = list(range(k * blk, min((k + 1) * blk, B_eff)))
        if not reps:                    # only padding entries left
            break
        chroms = [r // m for r in reps]
        # m = 1: a slice, so an at-scale bucket's host arrays are not copied
        rows = slice(chroms[0], chroms[-1] + 1) if m == 1 else chroms
        restraints = _upload(batched, rows, dev)
        masks = trace.to_device(torch.as_tensor(bead_masks, dtype=torch.float32)[rows], dev)
        starts, seeds = [], []
        for i, (r, c) in enumerate(zip(reps, chroms)):
            rs = anneal._chromosome(restraints, i)
            x0 = None
            if xs is None and an.init != "random":   # the init draws nothing
                if (c, dev) not in inits:
                    inits[c, dev] = anneal.initial_structure(rs, an, masks[i])
                x0 = inits[c, dev]
            x, s = anneal._draws(rs, an, per, masks[i], x0, anneal.chromosome_generator(seed, r),
                                 None if xs is None else xs[r],
                                 None if noise_seeds is None else int(noise_seeds[r]))
            starts.append(x)
            seeds.append(s)
        parts.append(solve_bucket_impl(restraints, an, per, masks, xs=torch.stack(starts),
                                       noise_seeds=seeds))
    out = devices[0]

    def fold(a):
        a = torch.cat([p.to(out) for p in a])
        return a.reshape(C, m * per, *a.shape[2:])

    pick = None
    if parts[0].pick is not None:
        j = torch.arange(B_eff, device=out) % m
        pick = fold([p.pick for p in parts]) + (2 * per * j).reshape(C, m).repeat_interleave(
            per, dim=1)
    return AnnealResult(coords=fold([p.coords for p in parts]),
                        energies={k: fold([p.energies[k] for p in parts])
                                  for k in parts[0].energies},
                        history=fold([p.history for p in parts]), pick=pick)


def _layout(C: int, L_pad: int, devices: Sequence):
    """(chrom groups, padded batch, padded length) of an at-scale bucket of
    C chromosomes over `devices`: large_mesh_layout's nc groups of nb
    devices, the batch padded to a multiple of nc and L to one of nb."""
    groups = chrom_groups(devices, C)
    nc, nb = len(groups), groups[0].n
    return groups, -(-C // nc) * nc, -(-L_pad // nb) * nb


def _pad_batch(a, B_pad: int):
    """a's entries (a list or a tensor) followed by copies of entry 0 up to
    B_pad, the JAX runner's batch padding."""
    if a is None or len(a) == B_pad:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[:1].expand(B_pad - len(a), *a.shape[1:])])
    return list(a) + [a[0]] * (B_pad - len(a))


def bucket_stack(matrices: Sequence[np.ndarray], L_pad: int, devices: Sequence) -> np.ndarray:
    """The (B_pad, L', L') float32 pad/stack bucket_tiles_from_if builds, in
    the layout it uses over `devices` (batch padding with copies of entry
    0, L rounded up to the beads axis): made once by a caller that preps
    the bucket more than once (an alpha ensemble)."""
    _, B_pad, L_pad = _layout(len(matrices), L_pad, devices)
    return device_prep.pad_stack(_pad_batch(list(matrices), B_pad), L_pad)


@trace.spanned("prep.tiles")
def bucket_tiles_from_if(matrices: Sequence[np.ndarray], L_pad: int, rc, devices: Sequence,
                         stack: Optional[np.ndarray] = None, out_dtype: str = "float32"):
    """An at-scale bucket's exact tiles built on the devices straight from
    its IF matrices (ops.device_prep.exact_tiles_from_if_batched_device):
    -> (tiles, groups, B_pad, L'), tiles[g][r] being group g's rank r strip,
    ExactRestraints of (B_pad / nc, L' / nb, L') out_dtype tensors on its
    device (the solve's: bfloat16 under pair_bf16; the assessment views':
    float32). Each chromosome takes the weight exponent of its own true
    length. One chromosome on one device past the one-shot limit streams its
    prep."""
    groups, B_pad, L_pad = _layout(len(matrices), L_pad, devices)
    mats = _pad_batch(list(matrices), B_pad)
    p = rc.weight_exponent
    ps = [auto_weight_exponent(m.shape[0]) if p is None else p for m in mats]
    Cg = B_pad // len(groups)
    tiles = []
    for g, group in enumerate(groups):
        sl = slice(g * Cg, (g + 1) * Cg)
        one = group.n == 1   # one device a chromosome: whole tiles, maybe streamed
        t = device_prep.exact_tiles_from_if_batched_device(
            mats[sl], L_pad, rc, rc.weighting, ps[sl],
            stack=None if stack is None else stack[sl], device=group.lead,
            group=None if one else group, out_dtype=out_dtype)
        tiles.append([t] if one else t)
    return tiles, groups, B_pad, L_pad


@trace.spanned("request")
def solve_bucket_sharded_from_if(
    matrices: Sequence[np.ndarray],
    L_pad: int,
    cfg: PipelineConfig,
    devices: Optional[Sequence] = None,
    base_seed: Optional[int] = None,
    stack: Optional[np.ndarray] = None,
    xs: Optional[torch.Tensor] = None,
    noise_seeds=None,
):
    """An at-scale genome bucket from its IF matrices: its exact tiles built
    on the devices (bucket_tiles_from_if) and solved by the chrom x beads
    genome solver (solver.sharded.solve_genome_sharded) over `devices` (the
    first CUDA device when None; a list may name one device several
    times). The batch is padded with copies of entry 0 where the chromosome
    groups do not divide it, and stripped after. Chromosome c draws from
    chromosome_generator(base_seed, c), base_seed defaulting to cfg.seed;
    xs (C, n_eff, L', 3) and noise_seeds (C,) replay given draws instead.
    Only for exact restraints (matrix-derived ones are: auto_exact_matrix).
    Under cfg.anneal.pair_bf16 the tiles are stored bfloat16 (the JAX
    package's solve_dtype).

    Returns (AnnealResult with a leading C axis, the live tiles, L'): the
    caller downloads each chromosome's assessment view from float32 tiles
    (bucket_views); bf16 ones it frees and preps again at float32
    (run_genome)."""
    devices = [resolve_device(None)] if devices is None else list(devices)
    C = len(matrices)
    tiles, groups, B_pad, L_pad = bucket_tiles_from_if(
        matrices, L_pad, cfg.restraints, devices, stack=stack,
        out_dtype=pipeline.solve_tile_dtype(cfg, True))
    masks = np.zeros((B_pad, L_pad), np.float32)
    for b, m in enumerate(_pad_batch(list(matrices), B_pad)):
        masks[b, :m.shape[0]] = 1.0
    log.info(f"at-scale bucket: {C} chromosomes (L_pad={L_pad}) on {len(groups)} chrom x "
             f"{groups[0].n} beads devices")
    result = solve_genome_sharded(
        groups, tiles, cfg.anneal, cfg.model_count, torch.from_numpy(masks),
        base_seed=cfg.seed if base_seed is None else base_seed,
        xs=_pad_batch(xs, B_pad), noise_seeds=_pad_batch(noise_seeds, B_pad))
    return AnnealResult(
        coords=result.coords[:C], energies={k: v[:C] for k, v in result.energies.items()},
        history=result.history[:C], pick=None if result.pick is None else result.pick[:C]
    ), tiles, L_pad


def _host_strip(a, rows: slice, chroms: Sequence[int], L_all: int, dev) -> torch.Tensor:
    """Rows `rows` of chromosomes `chroms` of a (C, L, L) host array or
    tensor, zero-padded to L_all columns (and rows), as one (len(chroms),
    Lb, L_all) float32 tensor on dev: a rank's strip, built without the
    whole tensor on any device."""
    L = a.shape[-1]
    r0, r1 = rows.start, rows.stop
    out = torch.zeros((len(chroms), r1 - r0, L_all), dtype=torch.float32)
    have = max(0, min(r1, L) - r0)
    for i, c in enumerate(chroms):
        if have:
            out[i, :have, :L] = torch.as_tensor(a[c][r0:r0 + have]).to("cpu", torch.float32)
    return trace.to_device(out, dev)


@trace.spanned("request")
def solve_bucket_sharded(
    batched,
    bead_masks,
    cfg: PipelineConfig,
    devices: Optional[Sequence] = None,
    base_seed: Optional[int] = None,
    xs: Optional[torch.Tensor] = None,
    noise_seeds=None,
    noise: Optional[Sequence] = None,
) -> AnnealResult:
    """Solve a bucket past the length buckets from its stacked restraints
    with the chrom x beads genome solver (solver.sharded.solve_genome_sharded)
    over `devices` (the first CUDA device when None; a list may name one
    device several times): the JAX package's solve_bucket_sharded. batched
    holds (C, L, L) host arrays (from _stack_bucket) or tensors, exact or
    windowed; bead_masks (C, L). The layout is parallel.shards.chrom_groups'
    (large_mesh_layout): the batch is padded with copies of entry 0 to a
    multiple of the chromosome groups and L to one of a group's devices
    (masked); both paddings are stripped on return. Each rank's strip is
    built straight from the host array (or the tensor), so the whole (C, L,
    L) tensor is never on one device. Chromosome c draws from
    chromosome_generator(base_seed, c), base_seed defaulting to cfg.seed;
    xs (C, n_eff, L', 3), L' the padded length, and noise_seeds (C,) replay
    given draws instead, and on the unfused route noise[c] chromosome c's
    noise draws. Returns an AnnealResult with a leading C axis."""
    devices = [resolve_device(None)] if devices is None else list(devices)
    names = [f.name for f in dataclasses.fields(batched)]
    C, L = getattr(batched, names[0]).shape[0], getattr(batched, names[0]).shape[-1]
    groups, B_pad, L_all = _layout(C, L, devices)
    Cg, nb = B_pad // len(groups), groups[0].n
    Lb = L_all // nb
    order = _pad_batch(list(range(C)), B_pad)
    strips = []
    for g, group in enumerate(groups):
        chroms = order[g * Cg:(g + 1) * Cg]
        strips.append([type(batched)(*(
            _host_strip(getattr(batched, k), slice(r * Lb, (r + 1) * Lb), chroms, L_all, d)
            for k in names)) for r, d in enumerate(group.devices)])
    masks = torch.zeros((B_pad, L_all), dtype=torch.float32)
    masks[:, :L] = torch.as_tensor(bead_masks, dtype=torch.float32).cpu()[order]
    log.info(f"at-scale bucket: {C} chromosomes (L_pad={L_all}) on {len(groups)} chrom x "
             f"{nb} beads devices, restraints stacked on the host")
    result = solve_genome_sharded(
        groups, strips, cfg.anneal, cfg.model_count, masks,
        base_seed=cfg.seed if base_seed is None else base_seed,
        xs=_pad_batch(xs, B_pad), noise_seeds=_pad_batch(noise_seeds, B_pad),
        noise=_pad_batch(noise, B_pad))
    return AnnealResult(
        coords=result.coords[:C, :, :L], energies={k: v[:C] for k, v in result.energies.items()},
        history=result.history[:C], pick=None if result.pick is None else result.pick[:C])


@trace.spanned("prep.view")
def bucket_views(tiles, lengths: Sequence[int]):
    """Each chromosome's host assessment view from an at-scale bucket's live
    float32 tiles: (Restraints, ExactRestraints of (n, n) numpy) per
    chromosome, n its true length, its rows gathered over its group's ranks
    (the JAX runner's download of the live tiles, parallel/genome.py:695-725).
    The assessment never reads bf16 targets: bfloat16 tiles raise."""
    if tiles[0][0].target.dtype != torch.float32:
        raise TypeError(f"assessment views need float32 tiles, got {tiles[0][0].target.dtype}")
    Cg = tiles[0][0].target.shape[0]
    raw, views = [], []
    for c, n in enumerate(lengths):
        g, i = divmod(c, Cg)
        t, w = (torch.cat([trace.to_host(getattr(s, k)[i, :, :n])
                           for s in tiles[g]])[:n].numpy()
                for k in ("target", "w"))
        raw.append(restraints_from_exact_target(t))
        views.append(ExactRestraints(target=t, w=w))
    return raw, views


def _f32_views(matrices, L_pad: int, cfg: PipelineConfig, devices, stack, lengths):
    """The assessment views of an at-scale bucket solved on bf16-stored
    tiles, prepped again at float32 from its pad/stack (the JAX run_genome's
    re-prep, parallel/genome.py:635-684): one chromosome on one device past
    the one-shot limit streams each strip's final values to the host
    (device_prep.assessment_view_from_if_streamed), every other bucket has
    its float32 tiles built on the devices and downloaded (bucket_views)."""
    rc = cfg.restraints
    if (len(devices) == 1 and len(matrices) == 1
            and device_prep.should_stream_prep(L_pad, devices[0], "float32")):
        n = lengths[0]
        p = auto_weight_exponent(n) if rc.weight_exponent is None else rc.weight_exponent
        t, w = device_prep.assessment_view_from_if_streamed(
            matrices[0], L_pad, rc, rc.weighting, p, n_true=n, device=devices[0])
        return [restraints_from_exact_target(t)], [ExactRestraints(target=t, w=w)]
    tiles = bucket_tiles_from_if(matrices, L_pad, rc, devices, stack=stack)[0]
    return bucket_views(tiles, lengths)


def bucket_peak_bytes(C: int, L_pad: int, cfg: PipelineConfig, nb: int = 1,
                      exact: bool = True) -> int:
    """Estimated device peak of an at-scale bucket of C chromosomes on one
    device of a group of nb: C one-device solves' peaks
    (pipeline.solve_peak_bytes at 2 x models structures, exact or windowed;
    exact tiles at the width the device prep stores them, bfloat16 under
    pair_bf16), a 1 / nb share of them where the rows are sharded, plus the
    scratch of the pair kernel that runs once for the group's C x 2 x models
    structures: kernel B6's (exact), B5's or B5''s part / e_part
    (windowed)."""
    n_eff = pipeline._solve_structures(cfg)
    Lb = L_pad // nb
    if exact:
        scratch = strip_tri.strip_scratch_bytes(C * n_eff, L_pad, Lb)
    else:
        plan = general_pair.general_pair_plan(n_eff, L_pad, Lb)
        scratch = 4 * C * (math.prod(plan["part_shape"]) + math.prod(plan["e_part_shape"]))
    one = pipeline.solve_peak_bytes(L_pad, n_eff, exact,
                                    stored=pipeline.solve_tile_dtype(cfg, exact),
                                    pair_bf16=cfg.anneal.pair_bf16)
    return C * one // nb + scratch


def _fits(C: int, L_pad: int, cfg: PipelineConfig, devices: Sequence, exact: bool) -> bool:
    """Whether an at-scale bucket's chrom x beads layout over `devices`
    fits each of them (bucket_peak_bytes of a group's share, summed over
    the places a device is listed)."""
    groups, B_pad, L_all = _layout(C, L_pad, devices)
    share = bucket_peak_bytes(B_pad // len(groups), L_all, cfg, groups[0].n, exact)
    load: Dict[torch.device, int] = {}
    for d in devices:
        load[d] = load.get(d, 0) + share
    return all(n <= pipeline._memory_bytes(d) for d, n in load.items())


def bucket_devices(C: int, L_pad: int, cfg: PipelineConfig, dev,
                   exact: bool = True) -> List[torch.device]:
    """The devices an at-scale bucket runs on: [dev] where it fits dev
    (bucket_peak_bytes against its memory), else every visible card
    (device.shard_devices, chrom x beads) where that layout fits each of
    them; RuntimeError where it fits nowhere (before any device work)."""
    need = bucket_peak_bytes(C, L_pad, cfg, exact=exact)
    if need <= pipeline._memory_bytes(dev):
        return [dev]
    devices = device_mod.shard_devices()
    if len(devices) > 1 and _fits(C, L_pad, cfg, devices, exact):
        return devices
    raise RuntimeError(
        f"an at-scale bucket of {C} chromosomes at L_pad={L_pad} needs about "
        f"{need / 1e9:.2f} GB on one device (bucket_peak_bytes), more than the "
        f"{pipeline._memory_bytes(dev) / 1e9:.2f} GB of {dev}, and does not fit the "
        f"{len(devices)} visible card(s) either")


def _plan_large(buckets, max_bucket: int, cfg: PipelineConfig, dev, mesh=None):
    """{L_pad: devices} for every bucket past the length buckets, decided
    before any bucket is solved, with exact restraints (auto_exact_matrix)
    or windowed ones: with no mesh, bucket_devices' (the one device where
    the bucket fits it, else the visible cards); with a mesh (a device
    list), the mesh, where its chrom x beads layout fits each device.
    RuntimeError for a bucket that fits nowhere."""
    cfg_b = auto_exact_matrix(cfg)
    exact = _exact_provable(cfg_b)
    large = sorted(L for L in buckets if L > max_bucket)
    if mesh is None:
        return {L: bucket_devices(len(buckets[L]), L, cfg_b, dev, exact) for L in large}
    for L in large:
        if not _fits(len(buckets[L]), L, cfg_b, mesh, exact):
            raise RuntimeError(
                f"an at-scale bucket of {len(buckets[L])} chromosomes at L_pad={L} does not "
                f"fit the {len(mesh)} listed device(s) (bucket_peak_bytes a device)")
    return {L: mesh for L in large}


def run_genome(
    input_dir: str,
    output_dir: str,
    cfg: Optional[PipelineConfig] = None,
    jobs: Optional[List[GenomeJob]] = None,
    resume: bool = False,
    device=None,
    devices: Optional[Sequence] = None,
) -> Dict[str, Dict]:
    """The test.sh equivalent: every chr*_matrix.txt in input_dir (or
    `jobs`) is solved bucket by bucket and assessed; per-chromosome
    artifacts land in output_dir/<name>/, each chromosome's result in
    output_dir/checkpoint/.

    devices None: every bucket within the length buckets is solved on
    `device` (device.resolve_device: None is the first CUDA device, and
    raises without one; "cpu" runs the kernels' plain twins). A bucket past
    them runs on `device` too, or over every visible card where it would not
    fit it (bucket_devices): exact restraints through
    solve_bucket_sharded_from_if, windowed ones through solve_bucket (one
    device) or solve_bucket_sharded. So a genome's models do not depend on
    how many cards are visible.

    devices a list (the JAX runner's mesh=; make_mesh, one device may stand
    several times; `device` is then not read): every bucket runs over it.
    Buckets within the length buckets take solve_bucket's chrom x model
    layout (the alpha ensemble's extra solves too), buckets past them the
    chrom x beads solvers over the list (one device: as with devices None),
    where bucket_peak_bytes says the layout fits each device, checked before
    any bucket is solved.

    resume=True skips chromosomes already in the checkpoint store; the
    returned dict covers every job all the same (finished ones from the
    store). cfg.alpha_ensemble solves every bucket again per extra alpha,
    seeded cfg.seed + hash(alpha) % 10000 as the JAX runner seeds it, and
    pools the models into the Spearman ranking. Writes
    <output_dir>/summary.json: the per-chromosome summaries, a per-bucket
    phase breakdown in seconds (load / solve and download / extra alphas /
    emit) and the wall seconds."""
    cfg = cfg or PipelineConfig()
    mesh = None if devices is None else make_mesh(devices)
    dev = resolve_device(device) if mesh is None else mesh[0]
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
    large_devices = _plan_large(buckets, max_bucket, cfg, dev, mesh)
    exact_large = _exact_provable(auto_exact_matrix(cfg))
    for L_pad, bucket in sorted(buckets.items()):
        ph = phases[f"L{L_pad}"] = {"chromosomes": [j.name for j in bucket]}
        t_ph = [time.time()]

        def _phase(name):
            # close the running phase segment and start the next
            now = time.time()
            ph[name] = round(ph.get(name, 0.0) + (now - t_ph[0]), 2)
            t_ph[0] = now

        large = L_pad in large_devices
        devs = large_devices.get(L_pad, [dev])
        from_if = large and exact_large
        log.info(f"bucket L={L_pad}: {len(bucket)} chromosomes "
                 f"({', '.join(j.name for j in bucket)}) on "
                 + (f"{len(devs)} device(s) [at-scale]" if large
                    else str(dev) if mesh is None else f"{len(mesh)} device(s)"))

        def bucket_solve(batched, masks, cfg_x, seed=None):
            # a bucket stacked on the host: past the length buckets one
            # device, or the chrom x beads solver over the cards it spreads
            # to; within them one device, or chrom x model over the mesh
            if large and len(devs) > 1:
                return solve_bucket_sharded(batched, masks, cfg_x, devices=devs,
                                            base_seed=seed)
            return solve_bucket(batched, masks, cfg_x, base_seed=seed, device=dev,
                                devices=None if large else mesh)

        dense_views = None
        if from_if:
            # the IF matrices go straight to tiles on the device, exact by
            # construction; the assessment views come from float32 tiles
            matrices = [load_if_matrix(job.path) for job in bucket]
            cfg_b = auto_exact_matrix(cfg)
            # padded once where a later prep reuses it: the float32 views
            # after a pair_bf16 solve, the extra alphas' solves
            stack = (bucket_stack(matrices, L_pad, devs)
                     if cfg_b.anneal.pair_bf16 or cfg.alpha_ensemble else None)
            _phase("load_s")
            result, tiles, _ = solve_bucket_sharded_from_if(matrices, L_pad, cfg_b,
                                                            devices=devs, stack=stack)
            coords = trace.to_host(result.coords).numpy()   # synchronises
            if cfg_b.anneal.pair_bf16:
                # the solve read bf16-stored tiles: free them, then prep the
                # views at float32, so the two tile sets never coexist
                del tiles
                raw, dense_views = _f32_views(matrices, L_pad, cfg_b, devs, stack,
                                              [j.length for j in bucket])
            else:
                raw, dense_views = bucket_views(tiles, [j.length for j in bucket])
                del tiles
        else:
            batched, bead_masks, matrices, raw = _stack_bucket(bucket, L_pad, cfg)
            cfg_b = cfg
            if all(not r.negdev.any() and not r.posdev.any() for r in raw):
                cfg_b = auto_exact(cfg, raw[0])
            _phase("load_s")
            result = bucket_solve(batched, bead_masks, cfg_b)
            coords = trace.to_host(result.coords).numpy()   # synchronises
        energies_all = {k: trace.to_host(v).numpy() for k, v in result.energies.items()}
        _phase("solve_and_views_s")
        alphas = [cfg.restraints.alpha] * coords.shape[1]
        # the alpha ensemble: each extra alpha's models pool into the
        # Spearman ranking (the JAX runner's seeds)
        for extra_alpha in cfg.alpha_ensemble:
            if extra_alpha == cfg.restraints.alpha:
                continue
            cfg_x = cfg.replace(restraints=dataclasses.replace(cfg.restraints,
                                                               alpha=extra_alpha))
            seed_x = cfg.seed + hash(extra_alpha) % 10000
            if from_if:
                res_x, tiles_x, _ = solve_bucket_sharded_from_if(
                    matrices, L_pad, auto_exact_matrix(cfg_x), devices=devs,
                    base_seed=seed_x, stack=stack)
                del tiles_x   # solve-only: the views are the first alpha's
            else:
                batched_x, masks_x, _, raw_x = _stack_bucket(bucket, L_pad, cfg_x)
                cfg_bx = cfg_x
                if all(not r.negdev.any() and not r.posdev.any() for r in raw_x):
                    cfg_bx = auto_exact(cfg_x, raw_x[0])
                res_x = bucket_solve(batched_x, masks_x, cfg_bx, seed_x)
            coords = np.concatenate([coords, trace.to_host(res_x.coords).numpy()], axis=1)
            energies_all = {k: np.concatenate([v, trace.to_host(res_x.energies[k]).numpy()],
                                              axis=1)
                            for k, v in energies_all.items()}
            alphas += [extra_alpha] * res_x.coords.shape[1]
        _phase("alpha_s")
        stack = None   # the last prep of the bucket is done

        def emit_one(b, job):
            """Assessment and artifact emission for one chromosome: host
            work only (numpy, file I/O), so chromosomes emit on host threads
            at once."""
            L = job.length
            out = os.path.join(output_dir, job.name)
            os.makedirs(out, exist_ok=True)
            c = coords[b, :, :L, :]
            energies = {k: v[b] for k, v in energies_all.items()}
            dense_b = dense_views[b] if dense_views is not None else \
                dense_restraints_from_numpy(raw[b], cfg.restraints.weighting,
                                            cfg.restraints.weight_exponent, as_numpy=True)
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
