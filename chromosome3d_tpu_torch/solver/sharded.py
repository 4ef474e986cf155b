"""The row-sharded (sequence-parallel) solves — the port of
chromosome3d_tpu/solver/sharded.py `solve_ensemble_sharded` (its 1-D
`_ensemble_shard_fn` body on the fused-update and the unfused routes) and
`solve_single_sharded`.

The (L, L) restraint tensors are cut into row strips, one per rank of a
parallel.shards.ShardGroup. Per annealing step every rank runs its pair
kernel on its strip: B6 (ops.strip_tri) for exact restraints where the
strip-triangular pairing pays, else B2' (exact) or B5' (windowed) on its
row block (ops.pair_energy / ops.general_pair). The energy partials are
summed on the lead device in rank order, the gradient is summed (B6) or its
row blocks gathered (B5', B2'), the or-group term is added on the lead, and
kernel B4 runs once, on the lead, before the new coordinates are copied to
the other ranks (the JAX package runs the update on every device, whose
replicas are bitwise identical).
On the unfused route (`fuse_update=False`, the angle term, or strips the
fused route does not take; `_route`) each rank runs B2' or B5' on its
strip, the gradient rows are gathered on the lead, and the bonded terms,
the clip, optax's Adam, noise and the move run there once
(solver.unfused). `solve_single_sharded` runs that step on one structure,
B5' on every rank.

The phases around the steps are solver.anneal's `_phases`, shared with the
one-device solver; `_group_body` is their row-sharded backend, for the C
chromosomes of a shard group at once (`solve_genome_sharded`, the JAX
package's vmap of the body over a chrom x beads mesh; C = 1 for
`solve_ensemble_sharded`). The start is the landmark init from the sharded
rows (always landmark, whatever cfg.init; edges from the folded weight w >
0), then solver.anneal's `_draws`; the final canonical-weight terms are the
plain row-block energy (parallel.sharded_energy).

AnnealConfig.pair_bf16, as the JAX shard body has it: the strip route casts
its strips to bfloat16 for B6 (a no-op for strips the prep stored bf16);
B2' reads the strips as they are stored, bf16 only where the prep stored
them so; B5' and the windowed routes ignore the flag. The landmark start
and the final terms read the strips widened to float32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from chromosome3d_tpu_torch.config import AnnealConfig
from chromosome3d_tpu_torch.ops import strip_tri
from chromosome3d_tpu_torch.ops.energy import (
    DenseRestraints,
    ExactRestraints,
    or_group_energy,
    or_group_energy_grad,
)
from chromosome3d_tpu_torch.ops.general_pair import general_row_block_energy_grad
from chromosome3d_tpu_torch.ops.pair_energy import (
    bond_energy_grad,
    bond_energy_grad_stacked,
    exact_pair_tiles,
    exact_row_block_energy_grad,
)
from chromosome3d_tpu_torch.parallel.sharded_energy import row_block_energy_grad
from chromosome3d_tpu_torch.parallel.shards import ShardGroup
from chromosome3d_tpu_torch.solver.anneal import (
    AnnealResult,
    Schedule,
    _chromosome,
    _draws,
    _first,
    _phases,
    _refuse_unported,
    _semi_steps,
    _solve_one,
    _unfused,
    _unfused_run,
    chromosome_generator,
)
from chromosome3d_tpu_torch.solver.init import (
    chain_metric_rows,
    clip_landmark_targets,
    landmark_indices,
    landmark_triangulate,
    relax_landmarks_block,
    relax_landmarks_lower_block,
)
from chromosome3d_tpu_torch.utils import trace

_BIG = 1e6


def restraint_strips(group: ShardGroup, restraints) -> List:
    """Cut whole (L, L) restraints (ExactRestraints or DenseRestraints) into
    the group's row strips, each on its rank's device, same container type."""
    if isinstance(restraints, ExactRestraints):
        return [ExactRestraints(target=t, w=w) for t, w in
                zip(group.strips(restraints.target), group.strips(restraints.w))]
    parts = [group.strips(getattr(restraints, k)) for k in ("lo", "hi", "mask", "weight")]
    return [DenseRestraints(*p) for p in zip(*parts)]


@dataclasses.dataclass(frozen=True)
class _Tiles:
    """One rank's strip tiles: lo (the target for exact restraints), hi and
    the folded weight w, each (Lb, L) on the rank's device, or (C, Lb, L)
    for C chromosomes; float32, or bfloat16 where the prep stored them so
    or the strip route casts them (pair_bf16)."""

    lo: torch.Tensor
    hi: torch.Tensor
    w: torch.Tensor
    row_start: int


def _tiles(group: ShardGroup, strips: Sequence, L: int, dtype=None) -> List[_Tiles]:
    """Each rank's _Tiles, in the strips' stored dtype, or in `dtype`."""
    out = []
    for r, s in enumerate(strips):
        lo, w = exact_pair_tiles(s)
        hi = s.hi
        if dtype is not None:
            lo, hi, w = (a.to(dtype) for a in (lo, hi, w))
        out.append(_Tiles(lo.contiguous(), hi.contiguous(), w.contiguous(),
                          group.row_start(r, L)))
    return out


def _one_chromosome_tiles(group: ShardGroup, strips: Sequence, L: int,
                          dtype=None) -> List[_Tiles]:
    """_tiles of (Lb, L) strips, with a chromosome axis of 1."""
    return [dataclasses.replace(t, lo=t.lo[None], hi=t.hi[None], w=t.w[None])
            for t in _tiles(group, strips, L, dtype)]


def _kernel_tiles(tiles: List[_Tiles], cfg: AnnealConfig, route: str) -> List[_Tiles]:
    """The tiles the pair kernels read: on the strip route under pair_bf16,
    lo and w cast to bfloat16 for B6 (JAX sharded.py:458-462; no copy for
    strips stored bf16); the stored tiles everywhere else."""
    if route != "strip" or not cfg.pair_bf16:
        return tiles
    return [dataclasses.replace(t, lo=t.lo.to(torch.bfloat16).contiguous(),
                                w=t.w.to(torch.bfloat16).contiguous()) for t in tiles]


@trace.spanned("init.landmark_sharded")
def sharded_landmark_init(group: ShardGroup, strips: Sequence, bead_mask: torch.Tensor,
                          cfg: AnnealConfig) -> torch.Tensor:
    """The landmark-MDS start from the row strips (JAX sharded.py:306-361):
    Bellman-Ford sweeps over each rank's edge rows, min-reduced over the
    ranks; two-sided (cfg.embed_two_sided), the upper sweeps run through hi
    and the landmark rows' lower bounds rise by one inverse-triangle sweep,
    max-reduced, before the restrained targets are clipped into their
    windows. Edges come from the folded weight (w > 0); targets are read
    widened to float32 (strips stored bf16). Returns (L, 3) on the lead
    device, padding rows zero."""
    lead = group.lead
    L = strips[0].lo.shape[1]
    tiles = _tiles(group, strips, L)
    Lb = tiles[0].lo.shape[0]
    beads = group.broadcast(bead_mask)
    k = min(cfg.landmark_count, L)
    lidx = landmark_indices(L, k, bead_mask.sum(), device=lead)
    delta = chain_metric_rows(lidx, L, cfg.bond_length)

    pair_real, edges = [], []
    for t, bead in zip(tiles, beads):
        dev = t.lo.device
        rows = t.row_start + torch.arange(Lb, device=dev)[:, None]
        cols = torch.arange(L, device=dev)[None, :]
        real = (bead[t.row_start:t.row_start + Lb, None] * bead[None, :]) > 0
        target = t.hi.float() if cfg.embed_two_sided else 0.5 * (t.lo.float() + t.hi.float())
        e = torch.where(t.w > 0, target, torch.full_like(target, _BIG))
        e = torch.where(((rows - cols).abs() == 1) & real,
                        torch.clamp_max(e, cfg.bond_length), e)
        edges.append(torch.where(rows == cols, torch.zeros_like(e), e))
        pair_real.append(real)
    for _ in range(cfg.landmark_iters):
        cand = group.pmin([relax_landmarks_block(d, e, t.row_start)
                           for d, e, t in zip(group.broadcast(delta), edges, tiles)])
        delta = torch.minimum(delta, cand)
    del edges
    if cfg.embed_two_sided:
        lo_land, mask_land, cand = [], [], []
        for d, li, t, real in zip(group.broadcast(delta), group.broadcast(lidx), tiles,
                                  pair_real):
            mask_rows = (t.w > 0).to(d.dtype) * real.to(d.dtype)
            lo32 = t.lo.to(d.dtype)
            lo_rows = torch.where(mask_rows > 0, lo32, torch.zeros_like(lo32))
            lrel = li - t.row_start
            own = ((lrel >= 0) & (lrel < Lb))[:, None]
            lsafe = torch.clamp(lrel, 0, Lb - 1)
            lo_land.append(torch.where(own, lo_rows[lsafe], torch.full_like(d, -_BIG)))
            mask_land.append(torch.where(own, mask_rows[lsafe], torch.full_like(d, -_BIG)))
            cand.append(relax_landmarks_lower_block(d, lo_rows, t.row_start))
        delta = clip_landmark_targets(
            delta, torch.maximum(group.pmax(lo_land), group.pmax(cand)),
            group.pmax(mask_land))
    return landmark_triangulate(delta, lidx).to(torch.float32) * bead_mask[:, None]


def _route(cfg: AnnealConfig, L: int, n: int) -> str:
    """The JAX package's sharded route (sharded.py:266-296): with the
    fusable options (fuse_update, no angle term) and strips of a multiple
    of 8 rows, "strip" (B6 + B4) for exact restraints where
    strip_tri_feasible holds, else "rows" (B2' or B5', + B4) where
    row_block_feasible holds; "unfused" everywhere else. On the unfused
    route the JAX package runs its Pallas row block where Lb % 8 == 0 and
    row_block_feasible hold and its jnp row block `_row_block_energy_grad`
    elsewhere: both are TPU tiling rules (sublanes, scoped VMEM). The
    port's B2' and B5' take any strip (pair_energy.exact_pair_plan,
    general_pair.general_pair_plan), so they run there too; no plain twin
    runs on the card."""
    Lb = L // n
    exact = cfg.exact_restraints and cfg.noe_rswitch >= 1e8
    if not _unfused(cfg) and Lb % 8 == 0:
        if exact and strip_tri.strip_tri_feasible(L, n):
            return "strip"
        if strip_tri.row_block_feasible(L, n, exact):
            return "rows"
    return "unfused"


def _in_lockstep(bodies) -> list:
    """Run generator bodies (_group_body) step by step in turn, each one's
    next step before any one's step after it, so that groups on other
    devices run at once; returns their results in order."""
    results, live = [None] * len(bodies), list(range(len(bodies)))
    while live:
        for i in list(live):
            try:
                next(bodies[i])
            except StopIteration as done:
                results[i] = done.value
                live.remove(i)
    return results


def _pair_rows(group: ShardGroup, tiles: List[_Tiles], beads: Sequence, xT: torch.Tensor,
               weights, exact: bool, route: str):
    """(pair energies (B,), pair gradient (B, 3, L)) on the lead of (B, 3,
    L) coords there, B = C x n structures chromosome-major: on the "strip"
    route B6 on every rank for all C chromosomes, the partial gradients
    summed; else B2' (exact) or B5' on every rank's rows for all C
    chromosomes, the rows gathered. tiles[r] holds rank r's (C, Lb, L)
    strips, beads[r] the (C, L) bead masks on its device."""
    xTs = group.broadcast(xT)
    if route == "strip":
        parts = [strip_tri.strip_tri_energy_grad(x, t.lo, t.w, weights, b, t.row_start)
                 for x, t, b in zip(xTs, tiles, beads)]
        return group.psum([e for e, _ in parts]), group.psum([g for _, g in parts])
    if exact:
        parts = [exact_row_block_energy_grad(x, t.lo, t.w, weights, b, t.row_start)
                 for x, t, b in zip(xTs, tiles, beads)]
    else:
        parts = [general_row_block_energy_grad(x, t.lo, t.hi, t.w, weights, b, t.row_start)
                 for x, t, b in zip(xTs, tiles, beads)]
    return group.psum([e for e, _ in parts]), group.all_gather([g for _, g in parts], 2)


def _group_body(group: ShardGroup, tiles: List[_Tiles], bead_masks: torch.Tensor,
                cfg: AnnealConfig, n_models: int, xs: torch.Tensor, noise_seeds,
                route: str, or_groups=None, schedule: Optional[Schedule] = None,
                noise=None):
    """The row-sharded backend of solver.anneal's `_phases` for the C
    chromosomes of one shard group; returns the phases' generator (a yield
    a step). tiles[r] is rank r's (C, Lb, L) strips, the rest on the lead as
    `_phases` takes it. Every step each rank runs its pair kernel once for
    all C chromosomes (`_pair_rows`), then B4 once on the lead, or on the
    "unfused" route solver.unfused's update there (noise[c]: chromosome c's
    replayed draws; None: draw)."""
    exact = cfg.exact_restraints and cfg.noe_rswitch >= 1e8
    unfused = route == "unfused"

    def setup(table, seeds):
        beads = group.broadcast(bead_masks)
        # the pair kernels' tiles (bf16 on the strip route under pair_bf16); the
        # final terms read the stored ones
        ktiles = _kernel_tiles(tiles, cfg, route)

        def pair_T(xT, weights):
            return _pair_rows(group, ktiles, beads, xT, weights, exact, route)

        if unfused:
            # the pair rows of every rank gathered, then the or-group term and
            # the bonded terms (bond and angle) on the lead
            def energy_grad(x, weights):
                e_pair, gT = pair_T(x.transpose(1, 2).contiguous(), weights)
                g = gT.transpose(1, 2)
                if or_groups is not None:
                    e_og, g_og = or_group_energy_grad(x, or_groups, weights, bead_masks[0])
                    e_pair, g = e_pair + e_og, g + g_og
                e_b, g_b = bond_energy_grad_stacked(x, weights, bead_masks)
                return e_pair + e_b, g + g_b

            run = _unfused_run(energy_grad, table, bead_masks, cfg.gradient_clip, noise_seeds,
                               noise)
        else:
            run = _semi_steps(pair_T, or_groups, bead_masks, table, seeds)

        def hot_energy(state, coords, w_hot):
            xT = coords.transpose(1, 2).contiguous() if unfused else state
            return (pair_T(xT, w_hot)[0]
                    + bond_energy_grad_stacked(coords, table.base, bead_masks)[0])

        def final_terms(c, coords):
            base, bm = table.base, bead_masks[c]
            parts = [row_block_energy_grad(x, t.lo[c], t.hi[c], t.w[c], b[c], t.row_start, base)
                     for x, t, b in zip(group.broadcast(coords), tiles, beads)]
            e_noe, e_vdw = (group.psum([p[i] for p in parts]) for i in (0, 1))
            if or_groups is not None:
                e_noe = e_noe + or_group_energy(coords, or_groups, base, bm)
            e_bond = bond_energy_grad(coords, base, bm)[0]
            return {"noe": e_noe, "bon": e_bond, "vdw": e_vdw, "overall": e_noe + e_vdw + e_bond}

        return run, hot_energy, final_terms

    return _phases(cfg, n_models, xs, noise_seeds, bead_masks, schedule, or_groups, unfused,
                   {"chunked": True, "blocks": len(tiles)}, setup)


def solve_ensemble_sharded(
    group: ShardGroup,
    strips: Sequence,
    cfg: AnnealConfig,
    n_models: int,
    bead_mask: Optional[torch.Tensor] = None,
    or_groups=None,
    xs: Optional[torch.Tensor] = None,
    noise_seed: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    schedule: Optional[Schedule] = None,
    noise: Optional[Sequence] = None,
) -> AnnealResult:
    """Build n_models structures with the (L, L) work row-sharded over the
    group: strips[r] is rank r's (Lb, L) ExactRestraints or DenseRestraints
    strip on its device (restraint_strips cuts whole tensors), L = n Lb.
    bead_mask (L,), or_groups (ops.energy.OrGroupRestraints) and the result
    live on the lead device. The one-chromosome case of
    solve_genome_sharded's shard body; the route is `_route`'s. generator
    (for the jitter and the noise seed), xs, noise_seed, noise and schedule
    as solver.anneal.solve_ensemble_impl's; the start is the landmark init
    from the strips, and the unfused route draws its noise on the lead."""
    if len(strips) != group.n:
        raise ValueError(f"{len(strips)} strips for {group.n} shards")
    lead = group.lead
    L = strips[0].lo.shape[1]
    group.rows(L)
    _refuse_unported(cfg)
    route = _route(cfg, L, group.n)
    tiles = _one_chromosome_tiles(group, strips, L)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if bead_mask is None:
        bead_mask = torch.ones(L, dtype=torch.float32, device=lead)
    bead_mask = bead_mask.to(device=lead, dtype=torch.float32).contiguous()
    xs, noise_seed = _draws(cfg, n_models, bead_mask, generator,
                            lambda: sharded_landmark_init(group, strips, bead_mask, cfg),
                            xs, noise_seed)
    res, = _in_lockstep([_group_body(group, tiles, bead_mask[None], cfg, n_models, xs[None],
                                     [noise_seed], route, or_groups, schedule, [noise])])
    return _first(res)


def solve_genome_sharded(
    groups: Sequence[ShardGroup],
    strips: Sequence[Sequence],
    cfg: AnnealConfig,
    n_models: int,
    bead_masks: torch.Tensor,
    base_seed: int = 0,
    xs: Optional[torch.Tensor] = None,
    noise_seeds=None,
    noise: Optional[Sequence] = None,
) -> AnnealResult:
    """Many chromosomes past the length buckets, chrom x beads: the port of
    the JAX package's solve_genome_sharded (solver/sharded.py:598), which
    vmaps the shard body over each device's chromosomes of a 2-D mesh.
    groups are the nc shard groups of nb devices each
    (parallel.shards.chrom_groups); the B chromosomes split evenly over them
    in order (B a multiple of nc), group g taking chromosomes [g Cg, (g + 1)
    Cg). strips[g][r] is group g's rank r strip: ExactRestraints or
    DenseRestraints with (Cg, Lb, L) tensors on that rank's device, L = nb
    Lb. bead_masks (B, L).

    Chromosome c draws from solver.anneal.chromosome_generator(base_seed,
    c), as the JAX body draws from its chromosome's key; xs (B, n_eff, L, 3)
    and noise_seeds (B,) replay given values instead, and on the unfused
    route noise[c] chromosome c's noise draws. The route is `_route`'s, once
    for the bucket; each group runs its chromosomes as one batch
    (`_group_body`), and the groups' steps are queued in turn (step k of
    every group before step k + 1 of any), so groups on other devices run
    at once as the JAX mesh's do. Returns an AnnealResult on groups[0]'s
    lead with a leading B axis."""
    _refuse_unported(cfg)
    nc = len(groups)
    nb = groups[0].n
    if len(strips) != nc or any(len(s) != g.n for s, g in zip(strips, groups)):
        raise ValueError("strips must hold one list of rank strips a group")
    if any(g.n != nb for g in groups):
        raise ValueError("every group must hold the same number of devices")
    B, L = bead_masks.shape
    if B % nc:
        raise ValueError(f"B={B} must be a multiple of the {nc} chromosome groups")
    groups[0].rows(L)
    Cg = B // nc
    route = _route(cfg, L, nb)
    n_eff = n_models * 2 if cfg.enantiomer else n_models
    if xs is not None and tuple(xs.shape) != (B, n_eff, L, 3):
        raise ValueError(f"xs: shape {tuple(xs.shape)}, expected {(B, n_eff, L, 3)}")
    bodies = []
    for g, (group, group_strips) in enumerate(zip(groups, strips)):
        lead = group.lead
        masks = trace.to_device(bead_masks[g * Cg:(g + 1) * Cg].to(torch.float32),
                                lead).contiguous()
        draws = []
        for i, c in enumerate(range(g * Cg, (g + 1) * Cg)):
            draws.append(_draws(cfg, n_models, masks[i], chromosome_generator(base_seed, c),
                                lambda: sharded_landmark_init(
                                    group, [_chromosome(s, i) for s in group_strips], masks[i],
                                    cfg),
                                None if xs is None else xs[c],
                                None if noise_seeds is None else noise_seeds[c]))
        bodies.append(_group_body(group, _tiles(group, group_strips, L), masks, cfg, n_models,
                                  torch.stack([x for x, _ in draws]), [s for _, s in draws], route,
                                  noise=None if noise is None else
                                  list(noise[g * Cg:(g + 1) * Cg])))
    results = _in_lockstep(bodies)
    out = groups[0].lead
    return AnnealResult(
        coords=torch.cat([r.coords.to(out) for r in results]),
        energies={k: torch.cat([r.energies[k].to(out) for r in results])
                  for k in results[0].energies},
        history=torch.cat([r.history.to(out) for r in results]),
        pick=None if results[0].pick is None else torch.cat([r.pick.to(out)
                                                             for r in results]))


def solve_single_sharded(
    group: ShardGroup,
    strips: Sequence,
    cfg: AnnealConfig,
    x0: torch.Tensor,
    bead_mask: Optional[torch.Tensor] = None,
    schedule: Optional[Schedule] = None,
    generator: Optional[torch.Generator] = None,
    jitter: Optional[torch.Tensor] = None,
    noise: Optional[Sequence] = None,
):
    """Anneal one structure from x0 (L, 3) with the pair work row-sharded
    over the group (the JAX package's solve_single_sharded): every step each
    rank runs B5' (the general well over lo, hi and the folded w, whatever
    the restraints) on its strip, the gradient rows are gathered on the
    lead, and the bond and angle terms, the clip, optax's Adam, noise and
    the move run there. strips as solve_ensemble_sharded's; x0, bead_mask
    and the result on the lead. ValueError where L is not a multiple of the
    shard count. Returns (coords (L, 3), history (T,)), trajectory-equal to
    solver.anneal.solve_single on the same draws (generator, jitter and
    noise as there)."""
    L = x0.shape[0]
    n = group.n
    if L % n:
        raise ValueError(f"L={L} must be a multiple of the {n} shards")
    if len(strips) != n:
        raise ValueError(f"{len(strips)} strips for {n} shards")
    if any(tuple(s.lo.shape) != (L // n, L) for s in strips):
        raise ValueError(f"strips must be ({L // n}, {L}) each")
    _refuse_unported(cfg)
    lead = group.lead
    # B5' reads float32 strips (strips stored bf16 are widened once)
    tiles = _one_chromosome_tiles(group, strips, L, torch.float32)
    if bead_mask is None:
        bead_mask = torch.ones(L, dtype=torch.float32, device=lead)
    bead_mask = bead_mask.to(device=lead, dtype=torch.float32).contiguous()
    beads = group.broadcast(bead_mask[None])

    def energy_grad(x, weights):
        e, gT = _pair_rows(group, tiles, beads, x.transpose(1, 2).contiguous(), weights,
                           False, "unfused")
        e_b, g_b = bond_energy_grad(x, weights, bead_mask)
        return e + e_b, gT.transpose(1, 2) + g_b

    return _solve_one(x0, bead_mask, cfg, energy_grad, schedule, generator, jitter, noise)
