"""The annealing solver on the fused and semi routes — the port of
chromosome3d_tpu/solver/anneal.py `solve_ensemble_impl`.

The precomputed hot -> cool -> final schedule is one table of per-step rows
(`schedule_table`, the JAX solver's `srows`). On the fused route kernel B1
(ops.fused_step) walks the table's rows itself: one call of
`fused_steps_batched` runs a whole phase (the hot steps, then the rest), as
one launch on a CUDA device and through the plain twin's loop on the CPU.
The semi routes are a Python loop over the same rows: the pair terms come
from one kernel, with the weights of the table's row, and the update from
kernel B4 (ops.fused_update: bond, clip, Adam, noise and move), which reads
its step from a device counter set once a phase, its scalars from the
table's rows on the device, and writes the step's history row itself: kernel B3 (ops.tri_energy) for exact restraints past the fused
step's reach or with or-groups, kernel B5 (ops.general_pair) for general
(windowed / soft-square) restraints. Or-group rows add their group-min
term (ops.energy.or_group_energy) to the pair gradient before B4. The
enantiomer trial runs both mirror images through the hot phase, picks the
lower-energy member of each pair under the end-of-hot weights
(ops.pair_energy: B2, B3 at L >= 1024, or B5, plus the or-group term),
and only the winners continue, with their Adam moments and the step count
carried over (so the bias corrections and the noise stream stay aligned
with the schedule).

Routes: the port runs the JAX package's frozen-default dispatch with no
dispatch table (`tri_energy.use_triangular`, `fused_step_feasible`), so both
packages route every L the same way. The options still unported raise
NotImplementedError naming their ROADMAP item; nothing falls back silently.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from chromosome3d_tpu_torch.config import AnnealConfig
from chromosome3d_tpu_torch.ops import tri_energy
from chromosome3d_tpu_torch.ops.energy import (
    EnergyWeights,
    energy_terms,
    f32,
    or_group_energy_grad,
)
from chromosome3d_tpu_torch.ops.fused_step import (
    TABLE_COLS,
    ScheduleTable,
    fused_step_feasible,
    fused_step_tiles,
    fused_steps_batched,
)
from chromosome3d_tpu_torch.ops.fused_update import fused_update_table, step_counter
from chromosome3d_tpu_torch.ops.general_pair import (
    general_pair_energy_grad,
    general_pair_tiles,
)
from chromosome3d_tpu_torch.ops.pair_energy import (
    exact_pair_tiles,
    pair_energy_and_grad_batched,
)
from chromosome3d_tpu_torch.solver.init import (
    landmark_init,
    mds_init,
    random_init,
    spiral_init,
)

# at and past this (padded) L the JAX package evaluates the final energy
# terms row-chunked (`energy_terms_chunked`, anneal.py:585), not ported
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


def _clip_per_bead(g: torch.Tensor, clip: Optional[float]) -> torch.Tensor:
    """Scale each bead's gradient 3-vector (last axis) to at most `clip`
    norm; identity when clip is None."""
    if clip is None:
        return g
    norm = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True) + 1e-12)
    return g * torch.clamp_max(clip / norm, 1.0)


def _bias_corrections(T: int):
    """Adam's 1/(1 - b^t) columns for t = 1..T, computed in float32 like the
    JAX package's schedule columns."""
    t = torch.arange(1, T + 1, dtype=torch.float32)
    bc1 = 1.0 / (1.0 - torch.pow(torch.tensor(0.9, dtype=torch.float32), t))
    bc2 = 1.0 / (1.0 - torch.pow(torch.tensor(0.999, dtype=torch.float32), t))
    return bc1.tolist(), bc2.tolist()


def schedule_table(cfg: AnnealConfig, seed: int) -> ScheduleTable:
    """The whole schedule as one (T, 6) float32 table of TABLE_COLS, one row
    a step, with the solve's constants: what kernels B1 and B4 read on the
    card, and where the semi routes' loop takes the pair kernels' weights. The values are the JAX package's:
    `build_schedule`'s columns, the float32 product repel * vdw_radius, and
    Adam's bias corrections in float32."""
    sched = build_schedule(cfg)
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
    """The routes and options the port cannot run yet, each named."""
    if not cfg.fuse_update:
        raise NotImplementedError(
            "fuse_update=False selects the unfused route, not ported "
            "(ROADMAP A11)"
        )
    if cfg.angle_weight != 0.0:
        raise NotImplementedError(
            "angle_weight != 0 rides the unfused route, not ported (ROADMAP A11)"
        )
    if cfg.pair_bf16:
        raise NotImplementedError(
            "pair_bf16 tiles are not ported (ROADMAP: port-side pair_bf16)"
        )
    if cfg.gram_d2:
        raise NotImplementedError("gram_d2 is not ported (ROADMAP: do not port)")


def _refuse_unchunked_terms(L: int) -> None:
    """The one-device solve evaluates its final energy terms whole-matrix;
    the row-sharded solve has its own column-chunked terms and no such
    limit."""
    if L >= CHUNKED_TERMS_MIN_L:
        raise NotImplementedError(
            f"L={L} >= {CHUNKED_TERMS_MIN_L} needs the row-chunked final "
            "energy terms (energy_terms_chunked), not ported (ROADMAP A10)"
        )


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
) -> AnnealResult:
    """Build n_models structures on the restraints' device: one batched
    loop over all restarts (+ enantiomer pairs).

    or_groups: optional ops.energy.OrGroupRestraints; their group-min well
      joins the energy every step, the pick and the final terms, and keeps
      the solve off the fused route (B1 updates inside the kernel, before
      an outside gradient could join).
    generator: the CPU torch.Generator for the random draws (per-restart
      jitter, the noise-stream seed, a random init); a fresh one seeded 0
      when None.
    xs: an explicit (n_eff, L, 3) start ensemble, used as given (no init,
      no mirror signs, no jitter); noise_seed: an explicit int32 seed for
      the Langevin noise stream. Together they let a caller replay the
      values another implementation drew.
    """
    target = restraints.lo
    dev = target.device
    L = target.shape[0]
    _refuse_unported(cfg)
    _refuse_unchunked_terms(L)
    exact = cfg.exact_restraints and cfg.noe_rswitch >= 1e8
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if bead_mask is None:
        bead_mask = torch.ones(L, dtype=torch.float32, device=dev)
    bead_mask = bead_mask.to(device=dev, dtype=torch.float32).contiguous()
    n_eff = n_models * 2 if cfg.enantiomer else n_models

    if xs is None:
        if x0 is None:
            init = cfg.init
            if init == "auto":
                init = "mds" if L < 2048 else "landmark"
            if init == "mds":
                x0 = mds_init(restraints, bond_length=cfg.bond_length,
                              unknown_fill=cfg.mds_unknown_fill,
                              bead_mask=bead_mask,
                              two_sided=cfg.embed_two_sided)
            elif init == "landmark":
                x0 = landmark_init(restraints, bond_length=cfg.bond_length,
                                   k=cfg.landmark_count,
                                   n_iters=cfg.landmark_iters,
                                   bead_mask=bead_mask,
                                   two_sided=cfg.embed_two_sided)
            elif init == "spiral":
                x0 = spiral_init(L, bond_length=cfg.bond_length, device=dev)
            else:
                x0 = random_init(generator, L, device=dev)
        x0 = x0.to(device=dev, dtype=torch.float32) * bead_mask[:, None]
        if cfg.enantiomer:
            # pairs (direct, mirrored): flip the x axis of the shared embedding
            signs = torch.tensor([1.0, -1.0], device=dev).repeat(n_models)
        else:
            signs = torch.ones(n_eff, device=dev)
        flip = torch.stack([signs, torch.ones_like(signs), torch.ones_like(signs)], -1)
        jitter = torch.randn((n_eff, L, 3), generator=generator).to(dev)
        xs = x0[None] * flip[:, None, :] + cfg.init_noise * jitter * bead_mask[None, :, None]
    xs = xs.to(device=dev, dtype=torch.float32)
    if xs.shape != (n_eff, L, 3):
        raise ValueError(f"xs: shape {tuple(xs.shape)}, expected {(n_eff, L, 3)}")
    if noise_seed is None:
        noise_seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))

    table = schedule_table(cfg, noise_seed)
    base = table.base
    T = len(table.rows)
    xT = xs.transpose(1, 2).contiguous()
    muT = torch.zeros_like(xT)
    nuT = torch.zeros_like(xT)
    history = torch.empty((T, n_eff), dtype=torch.float32, device=dev)

    fused = (exact and or_groups is None and fused_step_feasible(L)
             and not tri_energy.use_triangular(L))
    if fused:
        # the fused route: a phase of the schedule is one call of kernel B1,
        # which walks the table's rows itself
        tiles = fused_step_tiles(restraints, bead_mask, base.noe)

        def run(k0: int, k1: int, xT, muT, nuT, hist):
            hist[k0:k1], xT, muT, nuT = fused_steps_batched(
                xT, muT, nuT, tiles, table, k0, k1, bead_mask)
            return xT, muT, nuT
    else:
        # the semi routes: pair terms in kernel B3 (exact) or B5 (general),
        # the or-group term added, the update in kernel B4; the tiles are
        # folded once, outside the loop
        if exact:
            pair_tiles = tuple(a.contiguous() for a in exact_pair_tiles(restraints))
            pair_grad = tri_energy.tri_energy_grad
        else:
            pair_tiles = general_pair_tiles(restraints)
            pair_grad = general_pair_energy_grad

        # the pair kernels take their weights from the host's copy of the
        # table; kernel B4 reads its step from a device counter, its scalars
        # from the table's device rows, and writes the history row itself
        weights_k = [table.weights(k) for k in range(T)]
        counter = step_counter(0, dev)

        def run(k0: int, k1: int, xT, muT, nuT, hist):
            counter.fill_(k0)
            spare = [None, None]   # B4's outputs of the step before last
            for n, k in enumerate(range(k0, k1)):
                e_pair, gT = pair_grad(xT, *pair_tiles, weights_k[k], bead_mask)
                if or_groups is not None:
                    e_og, g_og = or_group_energy_grad(
                        xT.transpose(1, 2), or_groups, weights_k[k], bead_mask
                    )
                    e_pair = e_pair + e_og
                    gT = gT + g_og.transpose(1, 2)
                xT, muT, nuT = fused_update_table(
                    xT, gT.contiguous(), muT, nuT, e_pair, bead_mask, table, counter,
                    hist, out=spare[n % 2])
                spare[n % 2] = (xT, muT, nuT)
            return xT, muT, nuT

    pick = None
    if cfg.enantiomer:
        hot = cfg.hot_steps
        xT, muT, nuT = run(0, hot, xT, muT, nuT, history)
        # handedness per pair by energy under the end-of-hot weights
        coords = xT.transpose(1, 2).contiguous()
        w_hot = table.weights(hot - 1)
        e_hot, _ = pair_energy_and_grad_batched(
            coords, restraints, w_hot, bead_mask, exact
        )
        if or_groups is not None:
            e_hot = e_hot + or_group_energy_grad(coords, or_groups, w_hot, bead_mask)[0]
        choice = torch.argmin(e_hot.reshape(n_models, 2), dim=1)
        pick = torch.arange(n_models, device=dev) * 2 + choice
        xT, muT, nuT = xT[pick], muT[pick], nuT[pick]
        history = history[:, pick].contiguous()
        xT, muT, nuT = run(hot, T, xT, muT, nuT, history)
    else:
        xT, muT, nuT = run(0, T, xT, muT, nuT, history)
    coords = xT.transpose(1, 2).contiguous()

    terms = energy_terms(coords, restraints, base, bead_mask, or_groups)
    # centroid to origin, padding excluded
    nvalid = bead_mask.sum()
    centroid = (coords * bead_mask[None, :, None]).sum(dim=1, keepdim=True) / nvalid
    coords = (coords - centroid) * bead_mask[None, :, None]
    return AnnealResult(coords=coords, energies=terms, history=history.T, pick=pick)
