"""Kernel B1: the fused annealing step, a whole phase of the schedule in
one launch (csrc/fused_steps.cu), and its plain PyTorch twins.

Replaces chromosome3d_tpu/ops/pallas_energy.py `_kernel_fused_step` (entry
`pallas_fused_step_batched`, tiles from `fused_step_tiles`, helpers
`_t_layout_bond` and `_t_layout_noise`) as the JAX solver runs it, inside a
compiled scan over the schedule's rows. Same contract and the same
(B, 3, L) state layout at the public face: pair energy and gradient in the
exact-restraint rsqrt-space algebra, chain bond, per-bead clip, Adam with
the bias corrections of the schedule, CLT-4 murmur3 Langevin noise (bitwise
the JAX package's) and x' = x + (-lr * upd + sigma * noise) * bead.

Unlike the Pallas entry, nothing is padded to a 128-multiple: the kernel
masks the ragged edge itself. Padded beads (bead_mask 0) with zero state
stay exactly zero in x, mu and nu.

The tiles may be float32 or bfloat16 (AnnealConfig.pair_bf16: the JAX
solver casts fused_step_tiles after the fold): the kernel's bf16 entry
point widens them on load, the twin on read; the state stays float32.

`fused_steps_batched` runs steps k0 <= k < k1 of a `ScheduleTable`: the plain
twin `fused_steps_plain` (a loop over `fused_step_plain`) for CPU tensors,
one launch of the persistent kernel for CUDA tensors, laid out by
`fused_steps_plan`. Given (C, L, L) tiles, (C, L) bead masks and C seeds it
runs the C chromosomes of a genome bucket in that one launch (the JAX
genome runner's vmap over its bucket, whose kernel takes tiles, mask and
seed per lane). `fused_step_batched` is its single-step face with the
step's scalars passed in. Each counts in plain integers on the function
(`fused_steps_batched.launches`, of them `.launches_bf16` on bf16 tiles,
and `.steps`, at the launch, and `fused_step_plain.calls`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from chromosome3d_tpu_torch.ops import _build
from chromosome3d_tpu_torch.ops.energy import _EPS, EnergyWeights, f32
from chromosome3d_tpu_torch.ops.pair_energy import (
    TILE_DTYPES,
    check_inputs,
    exact_pair_tiles,
    tile_dtype,
)
from chromosome3d_tpu_torch.utils import trace

_M32 = 0xFFFFFFFF
_SQRT3 = f32(np.sqrt(3.0))
_SALTS = (0x68E31DA4, 0xB5297A4D, 0x1B56C4E9, 0x7C15BD3F)


def _c_int32(v: int) -> int:
    """v mod 2^32 as the signed 32-bit int the C entry point takes (the
    kernel reinterprets it as uint32)."""
    v = int(v) & _M32
    return v - (1 << 32) if v >= (1 << 31) else v


def fused_step_feasible(L: int) -> bool:
    """The JAX package's frozen route rule (`fused_step_feasible`,
    pallas_energy.py:90-114): the fused step serves lengths whose
    128-padded size admits a 128-multiple row tile under its budget —
    Lp <= 2048. The port keeps the rule so both packages route the same
    lengths the same way; past it the semi route (kernels B3 + B4) runs."""
    Lp = -(-max(L, 8) // 128) * 128
    return any(
        t <= Lp and Lp % t == 0 and 14.5 * t * Lp * 4 <= 15.5e6
        for t in (Lp, 512, 384, 256, 128)
    )


def fused_step_tiles(restraints, bead_mask: torch.Tensor, noe_weight: float):
    """The step's static (L, L) float32 tiles, built once per solve:
    restraint target, weights pre-scaled by 2 * noe and pre-masked by bead
    validity, and the pre-masked vdw predicate (|i - j| >= 2 and both beads
    real). Restraints stored bf16 are widened first, as the JAX fold
    promotes them; a pair_bf16 solve casts the three tiles after the fold."""
    tgt, w_folded = (a.float() for a in exact_pair_tiles(restraints))
    L = tgt.shape[0]
    bm = bead_mask.to(torch.float32)
    pair_valid = bm[:, None] * bm[None, :]
    idx = torch.arange(L, device=tgt.device)
    nonbonded = ((idx[:, None] - idx[None, :]).abs() >= 2).to(torch.float32)
    return (
        tgt.contiguous(),
        ((2.0 * noe_weight) * w_folded * pair_valid).contiguous(),
        (nonbonded * pair_valid).contiguous(),
    )


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h * c mod 2^32 for int64 h in [0, 2^32), without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """The murmur3 finaliser on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def clt4_noise(seed: int, step: int, B: int, L: int, device) -> torch.Tensor:
    """(B, 3, L) float32 Langevin noise, bitwise equal to the JAX package's
    `_t_layout_noise`: four hashed uniforms over the element index
    bead * 3 + coord, summed in the same order, minus 2, times sqrt(3).
    uint32 arithmetic runs in int64 masked to 32 bits (torch's CPU support
    for uint32 shifts and products is partial)."""
    b = torch.arange(B, dtype=torch.int64, device=device)[:, None, None]
    coord = torch.arange(3, dtype=torch.int64, device=device)[None, :, None]
    row = torch.arange(L, dtype=torch.int64, device=device)[None, None, :]
    base = ((int(seed) + int(step) * 0x9E3779B9) & _M32) + b * 0x7FEB352D
    k = (row * 3 + coord) ^ (base & _M32)
    u = [(_mix32(k ^ s) >> 8).to(torch.float32) * (1.0 / (1 << 24)) for s in _SALTS]
    return (u[0] + u[1] + u[2] + u[3] - 2.0) * _SQRT3


def _bond_T(xT: torch.Tensor, bead_mask: torch.Tensor, bond_w: float,
            bond_len: float):
    """Chain bond energy rows (B, L) and gradient (B, 3, L) in the (3, L)
    layout (`_t_layout_bond`): bond i -> i+1 belongs to bead i, and
    dE/dx_i = fwd_{i-1} - fwd_i."""
    dn = xT[:, :, 1:] - xT[:, :, :-1]
    db = torch.sqrt((dn * dn).sum(1) + _EPS)
    v_next = bead_mask[:-1] * bead_mask[1:]
    bdev = db - bond_len
    fwd = (2.0 * bond_w * v_next * bdev / db)[:, None, :] * dn
    e = F.pad(bond_w * v_next * bdev * bdev, (0, 1))
    return e, F.pad(fwd, (1, 0)) - F.pad(fwd, (0, 1))


def fused_step_plain(
    xT, muT, nuT, tiles, weights: EnergyWeights, bead_mask,
    lr, sigma, bc1, bc2, seed, step, clip: Optional[float],
    b1: float = 0.9, b2: float = 0.999, eps_adam: float = 1e-8,
):
    """Plain twin of B1 (the `_kernel_fused_step` math, whole-matrix; the
    pair gradient summed as sum_j c_ij (x_i - x_j), like the kernel);
    bfloat16 tiles are widened as they are read."""
    fused_step_plain.calls += 1
    t, w, nb = (a.float() for a in tiles)
    B, _, L = xT.shape
    diffs = [xT[:, c, :, None] - xT[:, c, None, :] for c in range(3)]
    s = torch.full((B, L, L), _EPS, dtype=xT.dtype, device=xT.device)
    for diff in diffs:
        s = s + diff * diff
    rinv = torch.rsqrt(s)
    u = 1.0 - t * rinv
    wtu = w * u
    v = torch.clamp_min(weights.vdw_radius * rinv - 1.0, 0.0)
    nv = nb * v
    e_pair = (s * (0.25 * (wtu * u) + (0.5 * weights.vdw) * (nv * v))).sum(-1)
    c = wtu - (2.0 * weights.vdw) * nv
    gT = torch.stack([(c * diff).sum(-1) for diff in diffs], dim=1)

    e_bond, x_new, mu, nu = update_plain(
        xT, gT, muT, nuT, weights, bead_mask, lr, sigma, bc1, bc2, seed, step,
        clip, b1, b2, eps_adam,
    )
    return (e_pair + e_bond).sum(-1), x_new, mu, nu


fused_step_plain.calls = 0


def update_plain(xT, gT, muT, nuT, weights: EnergyWeights, bead_mask,
                 lr, sigma, bc1, bc2, seed, step, clip: Optional[float],
                 b1: float = 0.9, b2: float = 0.999, eps_adam: float = 1e-8):
    """The update half of a step given the pair gradient gT (the
    `_kernel_fused_update` math): chain bond, per-bead clip, Adam, CLT-4
    noise and the move. Returns (bond energy rows (B, L), xT', muT', nuT').
    B1's twin runs it after its pair terms, and B4's twin is it."""
    B, _, L = xT.shape
    e_bond, g_bond = _bond_T(xT, bead_mask, weights.bond, weights.bond_length)
    gT = gT + g_bond
    if clip is not None and clip > 0.0:
        gnorm = torch.sqrt((gT * gT).sum(1, keepdim=True) + 1e-12)
        gT = gT * torch.clamp_max(f32(clip) / gnorm, 1.0)

    # the JAX package holds b1, b2 and (1 - b) as float32 values
    one = np.float32(1.0)
    mu = f32(b1) * muT + f32(one - np.float32(b1)) * gT
    nu = f32(b2) * nuT + f32(one - np.float32(b2)) * gT * gT
    upd = (mu * f32(bc1)) / (torch.sqrt(nu * f32(bc2)) + f32(eps_adam))
    noise = clt4_noise(seed, step, B, L, xT.device)
    x_new = xT + (-f32(lr) * upd + f32(sigma) * noise) * bead_mask
    return e_bond, x_new, mu, nu


TABLE_COLS = ("lr", "sigma", "vdw", "vdw_radius", "bc1", "bc2")


@dataclasses.dataclass(frozen=True)
class ScheduleTable:
    """A solve's schedule as kernels B1 and B4 read it (the JAX solver's `srows`):
    one float32 row of TABLE_COLS per step, and what stays fixed — the
    weights whose vdw and vdw_radius the rows replace, the clip, Adam's
    constants and the noise stream's seed. Row r is step `first + r`."""

    rows: np.ndarray                 # (T, 6) float32, on the host
    base: EnergyWeights
    clip: Optional[float]
    seed: int
    first: int = 0
    b1: float = 0.9
    b2: float = 0.999
    eps_adam: float = 1e-8
    _on_device: Dict = dataclasses.field(default_factory=dict, compare=False,
                                         repr=False)

    def __post_init__(self):
        rows = self.rows
        if rows.dtype != np.float32 or rows.ndim != 2 or rows.shape[1] != len(TABLE_COLS):
            raise ValueError(f"rows must be (T, {len(TABLE_COLS)}) float32, got "
                             f"{rows.dtype} {rows.shape}")

    def check_range(self, k0: int, k1: int) -> None:
        if not self.first <= k0 < k1 <= self.first + len(self.rows):
            raise ValueError(f"steps [{k0}, {k1}) outside the table's "
                             f"[{self.first}, {self.first + len(self.rows)})")

    def scalars(self, k: int):
        """Step k as the single-step functions take it: (weights, lr, sigma,
        bc1, bc2), Python floats holding the row's float32 values."""
        lr, sigma, vdw, radius, bc1, bc2 = self.rows[k - self.first].tolist()
        return (dataclasses.replace(self.base, vdw=vdw, vdw_radius=radius),
                lr, sigma, bc1, bc2)

    def weights(self, k: int) -> EnergyWeights:
        return self.scalars(k)[0]

    def device_rows(self, device) -> torch.Tensor:
        """The rows on `device`, uploaded once."""
        key = str(torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = torch.from_numpy(self.rows).to(device).contiguous()
        return self._on_device[key]

    def device_seed(self, device) -> torch.Tensor:
        """[seed] as the (1,) int32 seed array of one chromosome on
        `device`, uploaded once."""
        key = f"seed {torch.device(device)}"
        if key not in self._on_device:
            self._on_device[key] = torch.tensor([_c_int32(self.seed)], dtype=torch.int32,
                                                device=device)
        return self._on_device[key]


def one_step_table(weights: EnergyWeights, lr, sigma, bc1, bc2, seed: int, step: int,
                   clip: Optional[float], b1: float = 0.9, b2: float = 0.999,
                   eps_adam: float = 1e-8) -> ScheduleTable:
    """The one-row table of a step whose scalars are passed in."""
    rows = np.array([[lr, sigma, weights.vdw, weights.vdw_radius, bc1, bc2]], np.float32)
    return ScheduleTable(rows=rows, base=weights, clip=clip, seed=int(seed),
                         first=int(step), b1=b1, b2=b2, eps_adam=eps_adam)


_THREADS, _WARPS = 256, 8     # csrc/warp_fold.cuh kThreads, kWarps
# columns a lane of the compiled resident variants; 24 serves 512 < L <= 768,
# where resident takes 9-21% less a step than streamed (NVIDIA H100 80GB HBM3,
# 700.00 W, scripts/fused_steps_probe_torch.py --modes: at L = 768 0.0268
# against 0.0305 ms a step at B = 20, 0.0147 against 0.0185 at B = 10)
_RESIDENT_CPL = (16, 24)
_STREAMED = (8, 2)            # (columns a lane, rows a warp) of the streamed variant
_WORK_REGS = 100              # registers a thread beside its tile registers
# staging one structure's x costs a block about what sweeping 8 rows of its
# pairs does (B1's parts at B = 10, L = 512: 1.8 us staging 3 structures
# against 3.3 us sweeping 16 rows of them; PERF.md section 6)
_STAGE_ROWS = 8


def _streamed_split(C: int, B: int, nrg: int, rows: int, n_sm: int) -> int:
    """Blocks along the row groups of a streamed launch over C > 1
    chromosomes, each chromosome's B structures one structure group (a
    pass then stages enough structures to keep the fold's overlap and the
    update's 32 lanes as busy as a lone launch's): the least work for the
    busiest block, which walks ceil(C / nsgb) groups and ceil(nrg / nrgb)
    row groups of each, staging each group's x once; ties go to fewer
    blocks."""
    def key(nrgb):
        nsgb = min(C, n_sm // nrgb)
        return (-(-C // nsgb) * B * (-(-nrg // nrgb) * rows + _STAGE_ROWS), nsgb * nrgb)
    return min(range(1, min(nrg, n_sm) + 1), key=key)


def fused_steps_plan(L: int, B: int, n_sm: int = 132, smem_max: int = _build.SMEM_MAX,
                     regs: int = 65536, C: int = 1, mode: Optional[str] = None) -> dict:
    """How the persistent kernel lays out L bead rows and C chromosomes of B
    structures each on a card of n_sm SMs (one 256-thread block an SM,
    smem_max bytes of shared memory a block, regs registers an SM). A block
    owns rows = 8 x rpw bead rows (a row group) of the structures of a
    structure group: sg structures of one chromosome, never two, nsgc
    groups a chromosome, nsg = C x nsgc in all. The grid is nsgb x nrgb
    blocks, never more than n_sm, because the steps meet at a grid barrier
    and every block must be resident; a block walks row groups rgb, rgb +
    nrgb, ... of structure groups sgb, sgb + nsgb, ...

    mode "resident" (L <= 768, a block for every row group of every
    chromosome): the tile values of a block's rows stay in registers for the
    whole launch, 3 x cpl x rpw a thread (cpl columns a lane, 32 cpl >= L),
    and mu, nu in shared memory; each block has one structure group (nsgb =
    nsg); of the rows-a-warp choices the one with the least work a warp (rpw
    x sg) wins, ties to the larger. mode "streamed": the tile registers are
    reloaded per 256-column chunk; for C = 1 every SM takes a row group
    (nrgb = min(nrg, n_sm)) and the rest go to structure groups, for C > 1
    a structure group is a whole chromosome and `_streamed_split` balances
    the busiest block. A block stages sp <= sg
    structures' x at a time (lx float4 columns each, lx the chunk multiple
    >= L), as many as shared memory holds, in equal passes. `mode` forces
    one of the two (a resident plan that cannot be made raises). Raises when
    not even one structure fits."""
    if L < 1 or B < 1 or C < 1:
        raise ValueError(f"empty batch: C={C}, B={B}, L={L}")
    if mode not in (None, "resident", "streamed"):
        raise ValueError(f"unknown mode {mode!r}")

    def layout(cpl, rpw, resident):
        rows = _WARPS * rpw
        nrg = -(-L // rows)
        if resident:
            nrgb, nsgc = nrg, max(1, min(B, n_sm // (C * nrg)))
        elif C == 1:
            nrgb = min(nrg, n_sm)
            nsgc = max(1, min(B, n_sm // nrgb))
        else:
            nrgb, nsgc = _streamed_split(C, B, nrg, rows, n_sm), 1
        sg = -(-B // nsgc)
        nsgc = -(-B // sg)
        nsg = C * nsgc
        nsgb = nsg if resident else min(nsg, n_sm // nrgb)
        lx = -(-L // (32 * cpl)) * 32 * cpl
        per = 16 * lx + _WARPS * rpw * 16          # staged x + the warps' row sums
        fixed = rows * sg * 24 if resident else 0  # mu, nu of the block's rows
        sp = min(sg, (smem_max - fixed) // per)
        if sp < 1:
            return None
        sp = -(-sg // -(-sg // sp))                # equal passes
        return {"mode": "resident" if resident else "streamed", "cpl": cpl, "rpw": rpw,
                "rows": rows, "nrg": nrg, "nrgb": nrgb, "C": C, "nsgc": nsgc,
                "nsg": nsg, "nsgb": nsgb, "blocks": nsgb * nrgb, "sg": sg, "sp": sp,
                "lx": lx, "threads": _THREADS, "smem_bytes": sp * per + fixed}

    cands = []
    cpl = next((c for c in _RESIDENT_CPL if 32 * c >= L), None)
    if cpl is not None and mode != "streamed":
        for rpw in (2, 1):
            if (_THREADS * (3 * cpl * rpw + _WORK_REGS) <= regs
                    and C * -(-L // (_WARPS * rpw)) <= n_sm):
                plan = layout(cpl, rpw, True)
                if plan is not None:
                    cands.append(plan)
    if cands:
        return min(cands, key=lambda p: (p["rpw"] * p["sg"], -p["rpw"]))
    if mode == "resident":
        raise ValueError(f"fused_steps_plan: no resident layout for C={C}, B={B}, L={L} "
                         f"on {n_sm} SMs")
    plan = layout(*_STREAMED, False)
    if plan is None:
        raise ValueError(
            f"fused_steps_plan: one structure's x at L={L} does not fit {smem_max} "
            "bytes of shared memory")
    return plan


def _chromosome_args(t: torch.Tensor, B: int):
    """(C, structures a chromosome) of B structures on tiles given as (L, L)
    (C = 1) or (C, L, L)."""
    C = 1 if t.dim() == 2 else t.shape[0]
    if B % C:
        raise ValueError(f"{B} structures do not divide over {C} chromosomes")
    return C, B // C


def fused_steps_plain(xT, muT, nuT, tiles, table: ScheduleTable, k0: int, k1: int,
                      bead_mask, seeds):
    """Plain twin of the multi-step kernel: steps k0 <= k < k1 of the table
    through fused_step_plain -> (history (k1 - k0, B), xT', muT', nuT').
    seeds: C ints, one noise seed a chromosome. Tiles (L, L) and bead_mask
    (L,) are one chromosome (C = 1); tiles (C, L, L) and bead_mask (C, L) run
    each chromosome's B / C structures alone under its seed and stack the
    results in chromosome order."""
    table.check_range(k0, k1)
    seeds = [int(v) for v in seeds]
    if tiles[0].dim() == 2:
        tiles, bead_mask = tuple(a[None] for a in tiles), bead_mask[None]
    C, n = _chromosome_args(tiles[0], xT.shape[0])
    if len(seeds) != C:
        raise ValueError(f"{len(seeds)} seeds for {C} chromosomes")
    outs = []
    for c in range(C):
        sl = slice(c * n, (c + 1) * n)
        x, mu, nu = xT[sl], muT[sl], nuT[sl]
        hist = []
        for k in range(k0, k1):
            weights, lr, sigma, bc1, bc2 = table.scalars(k)
            e, x, mu, nu = fused_step_plain(
                x, mu, nu, tuple(a[c] for a in tiles), weights, bead_mask[c], lr, sigma,
                bc1, bc2, seeds[c], k, table.clip, table.b1, table.b2, table.eps_adam)
            hist.append(e)
        outs.append((torch.stack(hist), x, mu, nu))
    return (torch.cat([o[0] for o in outs], 1),
            *(torch.cat([o[i] for o in outs]) for i in (1, 2, 3)))


def fused_steps_batched(
    xT: torch.Tensor, muT: torch.Tensor, nuT: torch.Tensor, tiles,
    table: ScheduleTable, k0: int, k1: int, bead_mask: torch.Tensor,
    seeds: Optional[torch.Tensor] = None, mode: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Steps k0 <= k < k1 of the schedule -> (history (k1 - k0, B), xT',
    muT', nuT'), state (B, 3, L) float32; the noise of step k is structure
    b's stream at the global step k. tiles = fused_step_tiles(...), all
    float32 or all bfloat16 (pair_bf16): (L, L)
    each with bead_mask (L,) for a batch sharing one restraint set, or (C,
    L, L) each with bead_mask (C, L) for C chromosomes of B / C structures,
    chromosome-major, with seeds (C,) int32 on the state's device (None:
    [table.seed], for C = 1 only); chromosome c's outputs are bitwise those
    of a launch of its own in the same plan mode (`mode` forces one, see
    fused_steps_plan). CPU tensors run the plain twin; CUDA tensors make
    one cooperative launch of csrc/fused_steps.cu on copies of the state (the
    inputs are left as they are), or raise with the CUDA error."""
    if xT.dim() != 3:
        raise ValueError(f"xT must be (B, 3, L), got {tuple(xT.shape)}")
    B, L = xT.shape[0], xT.shape[2]
    t, w, nb = tiles
    C, n = _chromosome_args(t, B)
    lead = () if t.dim() == 2 else (C,)
    specs = {
        "xT": (xT, (B, 3, L)), "muT": (muT, (B, 3, L)), "nuT": (nuT, (B, 3, L)),
        "t": (t, (*lead, L, L), TILE_DTYPES), "w": (w, (*lead, L, L), TILE_DTYPES),
        "nb": (nb, (*lead, L, L), TILE_DTYPES), "bead_mask": (bead_mask, (*lead, L)),
    }
    dev = check_inputs(specs)
    kind = tile_dtype(t, w, nb)
    if B == 0 or L == 0:
        raise ValueError(f"empty batch: B={B}, L={L}")
    if seeds is None:
        if C != 1:
            raise ValueError(f"seeds must be given for {C} chromosomes")
        seeds = torch.tensor([_c_int32(table.seed)], dtype=torch.int32, device=dev)
    if seeds.dtype != torch.int32 or tuple(seeds.shape) != (C,) or seeds.device != dev:
        raise ValueError(f"seeds must be ({C},) int32 on {dev}, got {seeds.dtype} "
                         f"{tuple(seeds.shape)} on {seeds.device}")
    table.check_range(k0, k1)
    if dev.type == "cpu":
        return fused_steps_plain(xT, muT, nuT, tiles, table, k0, k1, bead_mask,
                                 seeds.tolist())
    lib = _build.load_library()
    nk = k1 - k0
    plan = fused_steps_plan(
        L, n, torch.cuda.get_device_properties(dev).multi_processor_count, C=C,
        mode=mode)
    rows = table.device_rows(dev)[k0 - table.first:k1 - table.first]
    x_a, mu, nu = xT.clone(), muT.clone(), nuT.clone()
    x_b = torch.empty_like(xT)
    part = torch.empty((nk, B, plan["nrg"] * plan["rpw"]), dtype=torch.float32, device=dev)
    hist = torch.empty((nk, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.entry(lib, "c3d_fused_steps", kind)(
            x_a.data_ptr(), x_b.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            t.data_ptr(), w.data_ptr(), nb.data_ptr(), bead_mask.data_ptr(),
            seeds.data_ptr(), rows.data_ptr(),
            part.data_ptr(), hist.data_ptr(), B, L, k0, k1, n,
            plan["cpl"], plan["rpw"], int(plan["mode"] == "resident"), plan["nsgc"],
            plan["nsgb"], plan["nrgb"], plan["nrg"], plan["sg"], plan["sp"], plan["lx"],
            plan["smem_bytes"], table.b1, table.b2, table.eps_adam,
            table.base.bond, table.base.bond_length,
            -1.0 if table.clip is None else table.clip,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "c3d_fused_steps")
    fused_steps_batched.launches += 1
    fused_steps_batched.launches_bf16 += kind == torch.bfloat16
    fused_steps_batched.steps += nk
    # step k0 reads x_a and writes x_b, the next one back
    return hist, (x_b if nk % 2 else x_a), mu, nu


trace.count_launches(fused_steps_batched)
fused_steps_batched.launches_bf16 = 0   # of them, on bf16 tiles
fused_steps_batched.steps = 0


def fused_step_batched(
    xT: torch.Tensor, muT: torch.Tensor, nuT: torch.Tensor, tiles,
    weights: EnergyWeights, bead_mask: torch.Tensor,
    lr, sigma, bc1, bc2, seed: int, step: int, clip: Optional[float],
    b1: float = 0.9, b2: float = 0.999, eps_adam: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One annealing step with its scalars passed in -> (energies (B,), xT',
    muT', nuT'): fused_steps_batched over a one-row table. clip None or <= 0
    disables the clip."""
    table = one_step_table(weights, lr, sigma, bc1, bc2, seed, step, clip, b1, b2,
                           eps_adam)
    hist, xT, muT, nuT = fused_steps_batched(xT, muT, nuT, tiles, table, step, step + 1,
                                             bead_mask)
    return hist[0], xT, muT, nuT
