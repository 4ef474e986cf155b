"""The annealing solver — the port of chromosome3d_tpu/solver/anneal.py
`solve_ensemble_impl` on its fused, semi and unfused routes, of the JAX
genome runner's vmap of it over the chromosomes of a length bucket
(`solve_bucket_impl`; `solve_ensemble_impl` is its one-chromosome case),
and of `solve_single`, one structure from a given start.

The phases of a solve are written once, in `_phases`: the setup, the hot
phase, the enantiomer pick, the cool and final phases, the final canonical
terms and the centroid. Its two backends supply the step loop, the pick's
energies and the final terms: `_solve_stack` here (one device) and
solver.sharded's `_group_body` (row-sharded). The start draws (`_draws`),
the semi step loop (`_semi_steps`) and the unfused one (`_unfused_run`)
are shared the same way.

The precomputed hot -> cool -> final schedule is one table of per-step rows
(`schedule_table`, the JAX solver's `srows`). On the fused route kernel B1
(ops.fused_step) walks the table's rows itself: one call of
`fused_steps_batched` runs a whole phase. The semi routes are a Python loop
over the same rows: the pair terms from one kernel, the or-group term
(ops.energy.or_group_energy), then kernel B4 (ops.fused_update: bond, clip,
Adam, noise and move), which reads its step from a device counter and its
scalars from the table's rows on the device. On one device the pair kernel
is B3 (ops.tri_energy) for exact restraints where B1 does not run (past the
fused step's reach, with or-groups, or where the dispatch table says so)
and B5 (ops.general_pair) for general (windowed / soft-square) restraints.
The enantiomer trial runs both mirror images through the hot phase, picks
the lower-energy member of each pair under the end-of-hot weights, and only
the winners continue, with their Adam moments and the step count carried
over. The final canonical terms are whole-matrix below CHUNKED_TERMS_MIN_L
and in row blocks from it (ops.energy `energy_terms_chunked`).

The unfused route is the JAX package's optax/threefry step, taken for
`fuse_update=False` and for a nonzero `angle_weight` (B1 and B4 carry no
angle term): every step the pair term of `pair_energy_and_grad_batched`
(B2, B3 at L >= 1024, or B5, with the bond and angle terms), the or-group
term, then the clip, optax's Adam, noise drawn on the device and the move
in torch ops (solver.unfused). `solve_single` runs the same step on one
structure.

AnnealConfig.pair_bf16 (exact restraints only; the windowed routes ignore
it, as the JAX package's do): the pair kernels read bfloat16 restraint
tiles, cast once a solve where the JAX solver casts them (B1's folded
tiles, the semi route's, the unfused route's and the pick's), or as the
prep stored them (at scale). The init and the final terms read the
restraints in float32. `solve_single` casts nothing, as the JAX one does not.

Routes (`step_route`): the JAX package's dispatch, `fused_step_feasible`
and `tri_energy.use_triangular` with its measured table where one exists
(ops.calibrate) and its frozen defaults elsewhere, asked with the
structures of one chromosome; CHROM3D_NO_TRI sends the exact semi route to
the unfused step. The options still unported raise NotImplementedError
naming their ROADMAP item; nothing falls back silently.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from chromosome3d_tpu_torch.config import AnnealConfig
from chromosome3d_tpu_torch.ops import tri_energy
from chromosome3d_tpu_torch.ops.energy import (
    EnergyWeights,
    chunked_row_blocks,
    energy_terms,
    energy_terms_chunked,
    f32,
    or_group_energy,
    or_group_energy_grad,
    widened,
)
from chromosome3d_tpu_torch.ops.fused_step import (
    TABLE_COLS,
    ScheduleTable,
    _c_int32,
    fused_step_feasible,
    fused_step_tiles,
    fused_steps_batched,
)
from chromosome3d_tpu_torch.ops.fused_update import fused_update_table, step_counter
from chromosome3d_tpu_torch.ops.general_pair import general_pair_energy_grad
from chromosome3d_tpu_torch.ops.pair_energy import (
    as_tile_dtype,
    pair_energy_and_grad_batched,
    pair_tiles,
)
from chromosome3d_tpu_torch.solver.init import (
    landmark_init,
    mds_init,
    random_init,
    spiral_init,
)
from chromosome3d_tpu_torch.solver.unfused import (
    NoiseStream,
    StackedNoise,
    drain,
    unfused_steps,
)
from chromosome3d_tpu_torch.utils import trace

# at and past this (padded) L the final energy terms are evaluated in row
# blocks (energy_terms_chunked), as the JAX package's are (anneal.py:585);
# below it the whole-matrix form keeps the JAX summation of the reference
# scale
CHUNKED_TERMS_MIN_L = 8192


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per-step hyperparameters as (T,) float32 host arrays."""

    lr: np.ndarray
    sigma: np.ndarray         # Langevin noise stddev (A)
    vdw_weight: np.ndarray
    repel_scale: np.ndarray


@dataclasses.dataclass(frozen=True)
class AnnealResult:
    coords: torch.Tensor                 # (n, L, 3), centred
    energies: Dict[str, torch.Tensor]    # each (n,), final canonical weights
    history: torch.Tensor                # (n, T) total energy per step
    pick: Optional[torch.Tensor] = None  # (n,) winners' indices in the 2n hot batch


def build_schedule(cfg: AnnealConfig) -> Schedule:
    """The hot -> cool -> final schedule; the same arrays as the JAX
    package's build_schedule (float64 host math, stored float32)."""
    hot_T = np.full(cfg.hot_steps, cfg.hot_temperature)
    hot_lr = np.full(cfg.hot_steps, cfg.hot_lr)
    hot_vdw = np.full(cfg.hot_steps, cfg.vdw_weight_start)
    hot_rep = np.full(cfg.hot_steps, cfg.repel_start)

    cycles = np.arange(cfg.cool_cycles)
    frac = cycles / max(cfg.cool_cycles - 1, 1)
    cyc_T = np.maximum(
        cfg.hot_temperature - (cycles + 1) * cfg.cool_temperature_step, 0.0
    )
    cyc_vdw = cfg.vdw_weight_start * (
        (cfg.vdw_weight_final / cfg.vdw_weight_start) ** frac
    )
    cyc_rep = cfg.repel_start + (cfg.repel_end - cfg.repel_start) * frac
    reps = cfg.cool_steps_per_cycle
    cool_T = np.repeat(cyc_T, reps)
    cool_vdw = np.repeat(cyc_vdw, reps)
    cool_rep = np.repeat(cyc_rep, reps)
    cool_lr = np.full(cfg.cool_steps, cfg.cool_lr)

    fsteps = np.arange(cfg.final_steps)
    final_lr = cfg.final_lr * 0.5 * (
        1.0 + np.cos(np.pi * fsteps / max(cfg.final_steps - 1, 1))
    )
    final_T = np.zeros(cfg.final_steps)
    final_vdw = np.full(cfg.final_steps, cfg.vdw_weight_final)
    final_rep = np.full(cfg.final_steps, cfg.repel_end)

    temp = np.concatenate([hot_T, cool_T, final_T])
    sigma = cfg.noise_scale * np.sqrt(temp / cfg.hot_temperature)

    def f32a(parts):
        return np.concatenate(parts).astype(np.float32)

    return Schedule(
        lr=f32a([hot_lr, cool_lr, final_lr]),
        sigma=sigma.astype(np.float32),
        vdw_weight=f32a([hot_vdw, cool_vdw, final_vdw]),
        repel_scale=f32a([hot_rep, cool_rep, final_rep]),
    )


def _final_weights(cfg: AnnealConfig) -> EnergyWeights:
    """Canonical end-of-protocol weights used for the ranking energies."""
    return EnergyWeights(
        noe=f32(cfg.noe_weight),
        bond=f32(cfg.bond_weight),
        bond_length=f32(cfg.bond_length),
        vdw=f32(cfg.vdw_weight_final),
        vdw_radius=f32(cfg.repel_end * cfg.vdw_radius),
        noe_rswitch=f32(cfg.noe_rswitch),
        angle=f32(cfg.angle_weight),
    )


def _bias_corrections(T: int):
    """Adam's 1/(1 - b^t) columns for t = 1..T, computed in float32 like the
    JAX package's schedule columns."""
    t = torch.arange(1, T + 1, dtype=torch.float32)
    bc1 = 1.0 / (1.0 - torch.pow(torch.tensor(0.9, dtype=torch.float32), t))
    bc2 = 1.0 / (1.0 - torch.pow(torch.tensor(0.999, dtype=torch.float32), t))
    return bc1.tolist(), bc2.tolist()


def schedule_table(cfg: AnnealConfig, seed: int,
                   schedule: Optional[Schedule] = None) -> ScheduleTable:
    """The whole schedule as one (T, 6) float32 table of TABLE_COLS, one row
    a step, with the solve's constants: what kernels B1 and B4 read on the
    card, and where the semi and unfused routes' loops take the pair
    kernels' weights (and the unfused one lr and sigma). The values are the
    JAX package's: `build_schedule`'s columns (or those of `schedule`, which
    overrides the one built from cfg), the float32 product repel *
    vdw_radius, and Adam's bias corrections in float32 as B4 reads them."""
    sched = build_schedule(cfg) if schedule is None else schedule
    bc1, bc2 = _bias_corrections(len(sched.lr))
    cols = {
        "lr": sched.lr, "sigma": sched.sigma, "vdw": sched.vdw_weight,
        "vdw_radius": sched.repel_scale * np.float32(cfg.vdw_radius),
        "bc1": np.asarray(bc1, np.float32), "bc2": np.asarray(bc2, np.float32),
    }
    rows = np.ascontiguousarray(
        np.stack([cols[name] for name in TABLE_COLS], axis=1), dtype=np.float32)
    return ScheduleTable(rows=rows, base=_final_weights(cfg), clip=cfg.gradient_clip,
                         seed=int(seed))


def _refuse_unported(cfg: AnnealConfig) -> None:
    """The options the port cannot run yet, each named."""
    if cfg.gram_d2:
        raise NotImplementedError("gram_d2 is not ported (ROADMAP: do not port)")


def chromosome_generator(base_seed: int, c: int) -> torch.Generator:
    """The generator chromosome c of a genome bucket draws from (its start
    ensemble's jitter, then its noise seed): a CPU torch.Generator seeded
    with the first word of numpy's SeedSequence([base_seed, c]), masked to
    63 bits. It stands in for the JAX runner's one key a chromosome,
    jax.random.split(PRNGKey(base_seed), C)[c] (parallel/genome.py)."""
    word = int(np.random.SeedSequence([int(base_seed), int(c)]).generate_state(
        1, np.uint64)[0])
    return torch.Generator().manual_seed(word & (2**63 - 1))


@trace.spanned("init.start")
def initial_structure(restraints, cfg: AnnealConfig, bead_mask: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One chromosome's init (L, 3) on bead_mask's device, by cfg.init
    ("auto": mds below L = 2048, landmark from it); "random" draws from
    `generator`."""
    dev, L = bead_mask.device, bead_mask.shape[0]
    init = cfg.init
    if init == "auto":
        init = "mds" if L < 2048 else "landmark"
    if init == "mds":
        # bf16-stored tiles: the embed's math runs on a float32 copy
        # (the small-L route); landmark_init widens its row strips
        return mds_init(widened(restraints), bond_length=cfg.bond_length,
                        unknown_fill=cfg.mds_unknown_fill, bead_mask=bead_mask,
                        two_sided=cfg.embed_two_sided)
    if init == "landmark":
        return landmark_init(restraints, bond_length=cfg.bond_length,
                             k=cfg.landmark_count, n_iters=cfg.landmark_iters,
                             bead_mask=bead_mask, two_sided=cfg.embed_two_sided)
    if init == "spiral":
        return spiral_init(L, bond_length=cfg.bond_length, device=dev)
    return random_init(generator, L, device=dev)


@trace.spanned("init.draws")
def _draws(cfg: AnnealConfig, n_models: int, bead_mask: torch.Tensor,
           generator: torch.Generator, start, xs=None, noise_seed=None):
    """One chromosome's start ensemble (n_eff, L, 3) and noise seed: the
    values given, or drawn — the init start() (called only where xs is not
    given: initial_structure, or the row-sharded landmark start), its mirror
    pairs and the jitter, then the seed, in that order from `generator`."""
    dev, L = bead_mask.device, bead_mask.shape[0]
    n_eff = n_models * 2 if cfg.enantiomer else n_models
    if xs is None:
        x0 = start().to(device=dev, dtype=torch.float32) * bead_mask[:, None]
        if cfg.enantiomer:
            # pairs (direct, mirrored): flip the x axis of the shared embedding
            signs = torch.tensor([1.0, -1.0], device=dev).repeat(n_models)
        else:
            signs = torch.ones(n_eff, device=dev)
        flip = torch.stack([signs, torch.ones_like(signs), torch.ones_like(signs)], -1)
        jitter = trace.to_device(torch.randn((n_eff, L, 3), generator=generator), dev)
        xs = x0[None] * flip[:, None, :] + cfg.init_noise * jitter * bead_mask[None, :, None]
    xs = xs.to(device=dev, dtype=torch.float32)
    if xs.shape != (n_eff, L, 3):
        raise ValueError(f"xs: shape {tuple(xs.shape)}, expected {(n_eff, L, 3)}")
    if noise_seed is None:
        noise_seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    return xs, int(noise_seed)


def _first(res: AnnealResult) -> AnnealResult:
    """The one chromosome of an AnnealResult with a leading C axis of 1."""
    return AnnealResult(coords=res.coords[0], energies={k: v[0] for k, v in res.energies.items()},
                        history=res.history[0], pick=None if res.pick is None else res.pick[0])


def _chromosome(restraints, c: int):
    """Chromosome c's (L, L) views of restraints stacked as (C, L, L)."""
    return type(restraints)(*(getattr(restraints, f.name)[c]
                              for f in dataclasses.fields(restraints)))


def _unfused(cfg: AnnealConfig) -> bool:
    """The JAX package's unfused route (anneal.py:322-323, `fusable` false):
    fuse_update off, or the angle term, which B1 and B4 do not carry."""
    return not cfg.fuse_update or cfg.angle_weight != 0.0


def step_route(cfg: AnnealConfig, L: int, or_groups=None, batch: Optional[int] = None,
               device=None) -> str:
    """The step route of a solve at L: "fused" (kernel B1), "semi" (B3 or
    B5, then B4) or "unfused" (solver.unfused) — the JAX package's choice
    (anneal.py:322-358). B1 for the fusable options, exact restraints, no
    or-groups, a length the fused step serves and the triangular kernel does
    not (`use_triangular(L, batch=batch)`, batch the structures of one
    chromosome: the JAX call sits under the genome vmap); exact restraints
    off B1 take B3 + B4 unless CHROM3D_NO_TRI is set, which sends them to
    the unfused step; general restraints B5 + B4. device: whose dispatch
    table entries decide."""
    if _unfused(cfg):
        return "unfused"
    if not (cfg.exact_restraints and cfg.noe_rswitch >= 1e8):
        return "semi"
    if (or_groups is None and fused_step_feasible(L)
            and not tri_energy.use_triangular(L, batch=batch, device=device)):
        return "fused"
    return "unfused" if os.environ.get("CHROM3D_NO_TRI") else "semi"


def _semi_steps(pair, or_groups, bead_mask: torch.Tensor, table: ScheduleTable,
                seeds: torch.Tensor):
    """The semi routes' step loop: run(k0, k1, xT, muT, nuT, hist), a
    generator over steps k0..k1-1 of (B, 3, L) state that yields after
    queueing each step and returns (xT, muT, nuT). A step is pair(xT,
    weights) -> (energies (B,), gradient (B, 3, L)), the or-group term, then
    kernel B4 with each chromosome's noise seed from `seeds`. bead_mask:
    B4's, (L,) or (C, L)."""
    weights = [table.weights(k) for k in range(len(table.rows))]
    counter = step_counter(0, seeds.device)
    og_mask = bead_mask if bead_mask.dim() == 1 else bead_mask[0]

    def run(k0: int, k1: int, xT, muT, nuT, hist):
        counter.fill_(k0)
        spare = [None, None]   # B4's outputs of the step before last
        for n, k in enumerate(range(k0, k1)):
            e_pair, gT = pair(xT, weights[k])
            if or_groups is not None:
                e_og, g_og = or_group_energy_grad(xT.transpose(1, 2), or_groups, weights[k],
                                                  og_mask)
                e_pair, gT = e_pair + e_og, gT + g_og.transpose(1, 2)
            xT, muT, nuT = fused_update_table(
                xT, gT.contiguous(), muT, nuT, e_pair, bead_mask, table, counter, hist,
                out=spare[n % 2], seeds=seeds)
            spare[n % 2] = (xT, muT, nuT)
            yield
        return xT, muT, nuT

    return run


def _unfused_run(energy_grad, table: ScheduleTable, bead_masks: torch.Tensor,
                 clip: Optional[float], noise_seeds, noise):
    """The unfused route's step loop (solver.unfused) for C chromosomes,
    each with its bead mask and its own noise stream on the masks' device,
    seeded by its noise seed or replaying noise[c] (None: draw)."""
    C = bead_masks.shape[0]
    draws = [None] * C if noise is None else noise
    return unfused_steps(energy_grad, table, bead_masks[0] if C == 1 else bead_masks, clip,
                         StackedNoise([NoiseStream(bead_masks.device, s, d)
                                       for s, d in zip(noise_seeds, draws)]))


def _phases(cfg: AnnealConfig, n_models: int, xs: torch.Tensor, noise_seeds,
            bead_masks: torch.Tensor, schedule: Optional[Schedule], or_groups,
            unfused: bool, terms_attrs: dict, setup):
    """The phases of a solve of C chromosomes at once (setup -> hot -> pick
    -> cool -> final terms -> centroid): a generator that yields wherever
    the step loop does and returns an AnnealResult with a leading C axis.
    xs (C, n_eff, L, 3), bead_masks (C, L) and noise_seeds (C ints) on the
    solve's device. The state is one batch of C x n_eff structures,
    chromosome-major, in the kernels' (B, 3, L) layout, or in the (B, L, 3)
    one of the optax step and its noise draws where `unfused`. The backend
    is setup(table, seeds), called inside `solve.setup`, which returns (run,
    hot_energy, final_terms): run(k0, k1, state, mu, nu, hist) the step
    loop, a generator returning (state, mu, nu); hot_energy(state, coords,
    weights) the pick's (B,) energies but the or-group term;
    final_terms(c, coords) chromosome c's final terms (span `solve.terms`,
    terms_attrs). The pick, the final terms and the centroid are taken
    chromosome by chromosome, so each chromosome's numbers are those of a
    solve of its own. Or-groups belong to one chromosome (no genome path has
    them, in the JAX package either): with C > 1 they raise ValueError."""
    C, n_eff, L = xs.shape[0], xs.shape[1], xs.shape[2]
    dev = xs.device
    if C > 1 and or_groups is not None:
        raise ValueError(f"or-groups belong to one chromosome, not to a stack of {C}: "
                         "no genome path carries them")
    with trace.span("solve.setup"):
        table = schedule_table(cfg, noise_seeds[0], schedule)
        T = len(table.rows)
        seeds = torch.tensor([_c_int32(v) for v in noise_seeds], dtype=torch.int32, device=dev)
        run, hot_energy, final_terms = setup(table, seeds)
        x = xs.reshape(C * n_eff, L, 3)
        xT = x.contiguous() if unfused else x.transpose(1, 2).contiguous()
        muT, nuT = torch.zeros_like(xT), torch.zeros_like(xT)
        history = torch.empty((T, C * n_eff), dtype=torch.float32, device=dev)

    def coords_of(state):
        return state if unfused else state.transpose(1, 2)

    # the step loops stay open across the yields, while other groups' bodies
    # run: they are no span's parent (nest=False)
    pick = None
    if cfg.enantiomer:
        hot = cfg.hot_steps
        with trace.span("solve.hot", nest=False):
            xT, muT, nuT = yield from run(0, hot, xT, muT, nuT, history)
        # handedness per mirror pair of each chromosome, by energy under the
        # end-of-hot weights
        with trace.span("solve.pick"):
            w_hot = table.weights(hot - 1)
            coords = coords_of(xT).contiguous()
            e_hot = hot_energy(xT, coords, w_hot)
            if or_groups is not None:
                e_hot = e_hot + or_group_energy(coords, or_groups, w_hot, bead_masks[0])
            choice = torch.argmin(e_hot.reshape(C, n_models, 2), dim=2)
            pick = torch.arange(n_models, device=dev) * 2 + choice          # (C, n)
            rows = (pick + n_eff * torch.arange(C, device=dev)[:, None]).reshape(-1)
            xT, muT, nuT = xT[rows], muT[rows], nuT[rows]
            history = history[:, rows].contiguous()
        with trace.span("solve.cool", nest=False):
            xT, muT, nuT = yield from run(hot, T, xT, muT, nuT, history)
    else:
        with trace.span("solve.hot", nest=False):
            xT, muT, nuT = yield from run(0, T, xT, muT, nuT, history)
    n = xT.shape[0] // C
    coords = coords_of(xT).reshape(C, n, L, 3)

    out_coords, terms = [], []
    with trace.span("solve.final"):
        for c in range(C):
            x = coords[c].contiguous()
            bm = bead_masks[c]
            # fenced before and at the end while traced: the span holds the
            # terms' device work, not the step kernels still queued
            trace.fence(dev)
            with trace.span("solve.terms", **terms_attrs):
                terms.append(final_terms(c, x))
                trace.fence(dev)
            # centroid to origin, padding excluded
            centroid = ((x * bm[None, :, None]).sum(dim=1, keepdim=True)
                        / torch.clamp_min(bm.sum(), 1.0))
            out_coords.append((x - centroid) * bm[None, :, None])
    return AnnealResult(
        coords=torch.stack(out_coords),
        energies={k: torch.stack([t[k] for t in terms]) for k in terms[0]},
        history=history.T.reshape(C, n, T), pick=pick)


def _solve_stack(rs, stacked, cfg: AnnealConfig, n_models: int, bead_masks: torch.Tensor,
                 xs: torch.Tensor, noise_seeds, or_groups=None,
                 schedule: Optional[Schedule] = None, noise=None) -> AnnealResult:
    """The one-device backend of `_phases` for C chromosomes: rs their (L,
    L) restraints, `stacked` the same as (C, L, L) tensors (None when C =
    1), the rest as there. Kernels B1 to B5 have the chromosome axis: one
    launch a phase or a step for the whole stack, and one for the pick.
    schedule overrides the one built from cfg; noise[c] replays chromosome
    c's unfused draws (solve_ensemble_impl's `noise`; None: draw)."""
    n_eff, L = xs.shape[1], xs.shape[2]
    exact = cfg.exact_restraints and cfg.noe_rswitch >= 1e8
    # pair_bf16 on an exact route: the pair kernels read bf16 tiles (the JAX
    # solver's `bf16=cfg.pair_bf16 and exact`)
    bf16 = cfg.pair_bf16 and exact
    route = step_route(cfg, L, or_groups, n_eff, xs.device)
    # the restraints and masks of the pair kernels and B4: one chromosome's,
    # or the stack's (the kernels' chromosome axis, a seed a chromosome)
    pick_r, pick_bm = (rs[0], bead_masks[0]) if len(rs) == 1 else (stacked, bead_masks)
    chunked = L >= CHUNKED_TERMS_MIN_L
    term_fn = energy_terms_chunked if chunked else energy_terms

    def setup(table, seeds):
        pick_tiles = None   # the pick folds its own tiles, unless the semi route's serve
        if route == "fused":
            # kernel B1 runs a whole phase, every chromosome in one launch
            # (pair_bf16: each chromosome's tiles cast after the fold)
            tiles = [as_tile_dtype(fused_step_tiles(r, bm, table.base.noe), bf16)
                     for r, bm in zip(rs, bead_masks)]
            tiles = tuple(a[0][None] if len(rs) == 1 else torch.stack(a) for a in zip(*tiles))

            def run(k0: int, k1: int, xT, muT, nuT, hist):
                hist[k0:k1], xT, muT, nuT = fused_steps_batched(
                    xT, muT, nuT, tiles, table, k0, k1, bead_masks, seeds=seeds)
                yield
                return xT, muT, nuT
        elif route == "unfused":
            # B2, B3 or B5 with the bonded terms (pair_energy_and_grad_batched,
            # the tiles folded once; one launch for the stack), the or-group term
            run = _unfused_run(_energy_grad(pick_r, exact, pick_bm, or_groups, bf16), table,
                               bead_masks, cfg.gradient_clip, noise_seeds, noise)
        else:
            # pair terms in kernel B3 (exact) or B5 (general); the tiles are
            # folded (and under pair_bf16 cast) once and serve the pick too
            pick_tiles = pair_tiles(pick_r, exact, bf16)
            pair_grad = tri_energy.tri_energy_grad if exact else general_pair_energy_grad
            run = _semi_steps(lambda xT, w: pair_grad(xT, *pick_tiles, w, pick_bm),
                              or_groups, pick_bm, table, seeds)

        def hot_energy(state, coords, w_hot):
            # one B2 or B3 launch for the whole stack, the table asked with a
            # chromosome's structures
            return pair_energy_and_grad_batched(coords, pick_r, w_hot, pick_bm, exact,
                                                pick_tiles, bf16=bf16)[0]

        def final_terms(c, x):
            return term_fn(x, rs[c], table.base, bead_masks[c], or_groups)

        return run, hot_energy, final_terms

    return drain(_phases(cfg, n_models, xs, noise_seeds, bead_masks, schedule, or_groups,
                         route == "unfused",
                         {"chunked": chunked, "blocks": chunked_row_blocks(L) if chunked else 0},
                         setup))


def _energy_grad(restraints, exact: bool, bead_mask: torch.Tensor, or_groups,
                 bf16: bool = False):
    """Every unfused step's (energies (B,), gradients (B, L, 3)) of (B, L,
    3) coords: the pair kernel with the bonded terms
    (pair_energy_and_grad_batched, its tiles folded once here, bfloat16
    under bf16) and the or-group term where given. Restraints of (C, L, L)
    tensors with (C, L) bead masks hold C chromosomes of B / C structures
    each. B3 or B2 is decided once for each batch size (before and after
    the pick), asked with a chromosome's structures, as the JAX package's
    trace of each phase under the genome vmap decides it."""
    tiles = pair_tiles(restraints, exact, bf16)
    tri: Dict[int, bool] = {}
    C = bead_mask.shape[0] if bead_mask.dim() == 2 else 1

    def energy_grad(x, weights):
        B, L = x.shape[0], x.shape[1]
        if exact and B not in tri:
            tri[B] = tri_energy.use_triangular(L, for_unfused=True, batch=B // C,
                                               device=x.device)
        e, g = pair_energy_and_grad_batched(x, restraints, weights, bead_mask, exact, tiles,
                                            tri=tri.get(B))
        if or_groups is not None:
            e_og, g_og = or_group_energy_grad(x, or_groups, weights, bead_mask)
            e, g = e + e_og, g + g_og
        return e, g

    return energy_grad


def _solve_one(x0: torch.Tensor, bead_mask: torch.Tensor, cfg: AnnealConfig, energy_grad,
               schedule: Optional[Schedule], generator: Optional[torch.Generator],
               jitter: Optional[torch.Tensor], noise):
    """The loop of solve_single and solve_single_sharded on bead_mask's
    device: x0 (L, 3) plus its jitter (given, or drawn from generator, a
    fresh one seeded 0 when None), the noise seed drawn next, then the unfused
    steps of energy_grad over the schedule. Returns (coords (L, 3), history
    (T,))."""
    dev, L = bead_mask.device, x0.shape[0]
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if jitter is None:
        jitter = torch.randn((L, 3), generator=generator)
    x = (x0.to(device=dev, dtype=torch.float32)
         + cfg.init_noise * jitter.to(device=dev, dtype=torch.float32) * bead_mask[:, None])
    noise_seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    table = schedule_table(cfg, noise_seed, schedule)
    draws = None if noise is None else [z[None] for z in noise]
    steps = unfused_steps(energy_grad, table, bead_mask, cfg.gradient_clip,
                          NoiseStream(dev, noise_seed, draws))
    T = len(table.rows)
    history = torch.empty((T, 1), dtype=torch.float32, device=dev)
    x, _, _ = drain(steps(0, T, x[None], torch.zeros_like(x[None]),
                          torch.zeros_like(x[None]), history))
    return x[0], history[:, 0]


def solve_single(
    restraints,
    cfg: AnnealConfig,
    x0: torch.Tensor,
    bead_mask: Optional[torch.Tensor] = None,
    schedule: Optional[Schedule] = None,
    or_groups=None,
    generator: Optional[torch.Generator] = None,
    jitter: Optional[torch.Tensor] = None,
    noise: Optional[Sequence] = None,
):
    """Anneal one structure from x0 (L, 3) plus its jitter, on the unfused
    step (the JAX package's solve_single): every step the pair kernel at B
    = 1 (B2, B3 at L >= 1024, or B5 for restraints that are not exact)
    with the bonded terms and any or-group term, then the clip, optax's
    Adam, noise and the move. No enantiomer pair, no final terms, no
    centroid. Returns (coords (L, 3), per-step total-energy history (T,)).

    generator: the CPU torch.Generator for the jitter, then the seed of the
    device generator the noise is drawn from (a fresh one seeded 0 when
    None). jitter: a given standard-normal (L, 3) draw instead of the
    generator's; noise: given draws, noise[k] the (L, 3) block of step k.
    schedule overrides the one built from cfg."""
    dev = restraints.lo.device
    _refuse_unported(cfg)
    if bead_mask is None:
        bead_mask = torch.ones(x0.shape[0], dtype=torch.float32, device=dev)
    bead_mask = bead_mask.to(device=dev, dtype=torch.float32).contiguous()
    exact = cfg.exact_restraints and cfg.noe_rswitch >= 1e8
    return _solve_one(x0, bead_mask, cfg, _energy_grad(restraints, exact, bead_mask, or_groups),
                      schedule, generator, jitter, noise)


def solve_ensemble_impl(
    restraints,
    cfg: AnnealConfig,
    n_models: int,
    bead_mask: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    or_groups=None,
    xs: Optional[torch.Tensor] = None,
    noise_seed: Optional[int] = None,
    schedule: Optional[Schedule] = None,
    noise: Optional[Sequence] = None,
) -> AnnealResult:
    """Build n_models structures on the restraints' device: one batched
    loop over all restarts (+ enantiomer pairs); the one-chromosome case of
    solve_bucket_impl.

    or_groups: optional ops.energy.OrGroupRestraints; their group-min well
      joins the energy every step, the pick and the final terms, and keeps
      the solve off the fused route (B1 updates inside the kernel, before
      an outside gradient could join).
    generator: the CPU torch.Generator for the random draws (per-restart
      jitter, the noise-stream seed, a random init); a fresh one seeded 0
      when None.
    xs: an explicit (n_eff, L, 3) start ensemble, used as given (no init,
      no mirror signs, no jitter); noise_seed: an explicit int32 seed for
      the Langevin noise stream (on the unfused route, the seed of the
      device generator the noise is drawn from). Together they let a
      caller replay the values another implementation drew.
    schedule: a Schedule that overrides the one built from cfg (the table
      B1 and B4 read is built from it).
    noise: on the unfused route, the standard-normal draws to replay
      instead of the device generator's, noise[k] the (B, L, 3) block of
      step k (B = n_eff through the hot phase, n_models after the pick
      with enantiomer pairs), as the JAX package draws one block a step.
    """
    dev = restraints.lo.device
    L = restraints.lo.shape[0]
    _refuse_unported(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if bead_mask is None:
        bead_mask = torch.ones(L, dtype=torch.float32, device=dev)
    bead_mask = bead_mask.to(device=dev, dtype=torch.float32).contiguous()
    xs, noise_seed = _draws(cfg, n_models, bead_mask, generator, lambda: (
        initial_structure(restraints, cfg, bead_mask, generator) if x0 is None else x0),
        xs, noise_seed)
    return _first(_solve_stack([restraints], None, cfg, n_models, bead_mask[None], xs[None],
                               [noise_seed], or_groups, schedule, [noise]))


def solve_bucket_impl(
    restraints,
    cfg: AnnealConfig,
    n_models: int,
    bead_masks: torch.Tensor,
    base_seed: int = 0,
    xs: Optional[torch.Tensor] = None,
    noise_seeds=None,
    noise: Optional[Sequence] = None,
) -> AnnealResult:
    """Solve the C chromosomes of a genome bucket together: restraints with
    (C, L, L) tensors (each chromosome's padded to the bucket's L),
    bead_masks (C, L) -> an AnnealResult with a leading C axis: coords (C,
    n_models, L, 3), energies (C, n_models) each, history (C, n_models, T),
    pick (C, n_models). Each chromosome's start is its own init (a loop
    over the chromosomes: a batched eigendecomposition may flip an
    eigenvector's sign), then the draws of chromosome_generator(base_seed,
    c); xs (C, n_eff, L, 3) and noise_seeds (C,) replay given values
    instead, and on the unfused route noise[c] chromosome c's noise draws.
    The C x n_eff structures run as one batch on every route (`_solve_stack`);
    chromosome c's results are those of solve_ensemble_impl on its own
    restraints with the same draws."""
    target = restraints.lo
    dev = target.device
    C, L = target.shape[0], target.shape[-1]
    _refuse_unported(cfg)
    bead_masks = bead_masks.to(device=dev, dtype=torch.float32).contiguous()
    if tuple(bead_masks.shape) != (C, L):
        raise ValueError(f"bead_masks: shape {tuple(bead_masks.shape)}, expected {(C, L)}")
    rs = [_chromosome(restraints, c) for c in range(C)]
    draws = []
    for c in range(C):
        gen = chromosome_generator(base_seed, c)
        draws.append(_draws(cfg, n_models, bead_masks[c], gen,
                            lambda: initial_structure(rs[c], cfg, bead_masks[c], gen),
                            None if xs is None else xs[c],
                            None if noise_seeds is None else noise_seeds[c]))
    return _solve_stack(rs, restraints, cfg, n_models, bead_masks,
                        torch.stack([d[0] for d in draws]), [d[1] for d in draws],
                        noise=noise)
