"""Kernel B6: the strip-triangular exact pair energy and gradient of one
shard of the row-sharded solve (csrc/exact_tri_strip.cu), its plain PyTorch
twin, and the sharded solver's routing rules. It takes a chromosome axis: a
genome bucket's C chromosomes (strips (C, Lb, L), masks (C, L), C x n
structures) in one launch, as the JAX genome solver vmaps the shard body.

Replaces chromosome3d_tpu/ops/pallas_energy.py `_kernel_exact_tri_strip`
(entry `pallas_strip_tri_energy_grad_batched`) together with
`assemble_strip_tri_grad`: each shard computes its row tiles' shells of the
global round-robin tile pairing (so the shards together compute every
unordered tile pair once) and returns its share of the (B, 3, L) gradient,
which the solver sums over the shards. The kernel shares B3's tile-pair
body (csrc/tri_pair.cuh). Its tile is the port's own (`strip_tile`); the
JAX package's VMEM-sized tile (`pick_tile_tri_strip`) is kept as part of
the routing rule, so both packages route every (L, shards) alike.

`strip_tri_energy_grad` runs the plain twin for CPU tensors and the CUDA
kernel for CUDA tensors (float32 strips, or bfloat16 ones under
AnnealConfig.pair_bf16: the bf16 entry point widens them on load, the
twin on read), counting each in a plain integer on the function
(`strip_tri_energy_grad.launches`, of them `.launches_bf16` on bf16
strips and `.launches_tile64` at tile 64, which take tri_pair.cuh's
swapped-patch body; `strip_tri_energy_grad_plain.calls`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from chromosome3d_tpu_torch.ops import _build
from chromosome3d_tpu_torch.ops.energy import _EPS, EnergyWeights
from chromosome3d_tpu_torch.ops.pair_energy import TILE_DTYPES, check_inputs, tile_dtype
from chromosome3d_tpu_torch.ops.tri_energy import tri_plan
from chromosome3d_tpu_torch.utils import trace

_STRIP_TILES = (64, 32, 16, 8)   # the instantiations in exact_tri_strip.cu


def pick_tile_tri_strip(Lb: int) -> int:
    """The JAX package's strip tile (pallas_energy.py:1554-1564): the
    largest of 512 .. 8 that divides the strip height under its VMEM
    budget. A routing input here, not the port's tile."""
    budget = 14 * 1024 * 1024
    for t in (512, 384, 256, 128, 64, 32, 16, 8):
        if t <= Lb and Lb % t == 0 and 22 * t * t * 4 <= budget:
            return t
    return 8


def strip_tri_feasible(L: int, n_dev: int) -> bool:
    """The JAX package's rule (pallas_energy.py:1567-1576): the strip kernel
    runs when tile boundaries align with shard boundaries and the matrix
    spans at least 3 tiles. Tests replace it to force a route."""
    if L % n_dev:
        return False
    Lb = L // n_dev
    TM = pick_tile_tri_strip(Lb)
    return Lb % TM == 0 and L % TM == 0 and L // TM >= 3


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pick_tile_rows(Lb: int, Lp: int, exact: bool) -> Optional[int]:
    """The JAX package's row-block tile (pallas_energy.py:1695-1708), None
    when even the minimum (8, Lp) tile exceeds its VMEM budget."""
    budget = 14 * 1024 * 1024
    u = 8.5 if exact else 10.5
    for t in (Lb, 512, 384, 320, 256, 128, 64, 32, 16, 8):
        if t <= Lb and Lb % t == 0 and u * t * Lp * 4 <= budget:
            return t
    return None


def row_block_feasible(L: int, n_dev: int, exact: bool) -> bool:
    """The JAX package's rule (pallas_energy.py:1711-1718) for the row-block
    kernels B5' and B2'; where it fails the JAX package falls back to an
    unfused route the port does not run."""
    Lp = _round_up(max(L, 8), 128)
    return _pick_tile_rows(L // n_dev, Lp, exact) is not None


def strip_tile(Lb: int) -> Optional[int]:
    """B6's tile for a strip of Lb rows: 64, or the largest of 32, 16 and 8
    that divides Lb; None when none does."""
    for t in _STRIP_TILES:
        if Lb % t == 0:
            return t
    return None


def strip_plan(B: int, L: int, Lb: int, row_start: int) -> dict:
    """B6's host plan for the Lb rows from row_start of length L:
    `tri_plan` at the strip's tile in the compact layout, plus the strip's
    first global row tile `row0t`. Raises ValueError where no tile of
    _STRIP_TILES divides Lb, row_start and L."""
    tile = strip_tile(Lb)
    if B <= 0 or tile is None or row_start % tile or L % tile or not (
            0 <= row_start <= L - Lb):
        raise ValueError(
            f"strip-tri needs a tile of {_STRIP_TILES} dividing Lb, row_start "
            f"and L: B={B}, rows [{row_start}, {row_start + Lb}) of {L}")
    plan = tri_plan(B, L, Lb, tile, compact=True)
    plan["row0t"] = row_start // tile
    return plan


def _chromosome_axis(xT: torch.Tensor, target: torch.Tensor, bead_mask: torch.Tensor):
    """(C, n): a strip (Lb, L) with bead_mask (L,) is one chromosome of all
    B structures; strips (C, Lb, L) with masks (C, L) are C chromosomes of
    B / C structures each, chromosome-major."""
    if target.dim() == 2:
        return 1, xT.shape[0]
    C = target.shape[0]
    if C == 0 or xT.shape[0] % C:
        raise ValueError(f"{C} chromosomes do not divide the {xT.shape[0]} structures")
    return C, xT.shape[0] // C


def _strip_one_plain(xT, target, w, weights, bead_mask, row_start, tile):
    """B6's twin for one chromosome (see strip_tri_energy_grad_plain)."""
    B, _, L = xT.shape
    Lb = target.shape[0]
    TM = tile
    Tl, Tg = Lb // TM, L // TM
    S = Tg // 2 + 1
    row0t = row_start // TM
    dev = xT.device
    x = xT.transpose(1, 2)                                         # (B, L, 3)
    ar = torch.arange(TM, device=dev)
    ti = torch.arange(Tl, device=dev)
    rows_l = ti[:, None] * TM + ar[None, :]                        # (Tl, TM)
    rows_g = rows_l + row_start
    e = torch.zeros(B, dtype=xT.dtype, device=dev)
    g = torch.zeros((B, L, 3), dtype=xT.dtype, device=dev)
    for s in range(S):
        ig = row0t + ti
        live = torch.ones(Tl, dtype=xT.dtype, device=dev)
        if Tg % 2 == 0 and s == S - 1:
            live = (ig < Tg // 2).to(xT.dtype)   # the double-covered shell's twin
        cols = ((ig + s) % Tg)[:, None] * TM + ar[None, :]          # (Tl, TM)
        tb = target[rows_l[:, :, None], cols[:, None, :]].float()   # (Tl, TM, TM)
        wb = w[rows_l[:, :, None], cols[:, None, :]].float()
        diff = x[:, rows_g][:, :, :, None, :] - x[:, cols][:, :, None, :, :]
        s2 = _EPS + diff[..., 0] * diff[..., 0]
        s2 = s2 + diff[..., 1] * diff[..., 1]
        s2 = s2 + diff[..., 2] * diff[..., 2]                      # (B, Tl, TM, TM)
        rinv = torch.rsqrt(s2)
        pv = bead_mask[rows_g][:, :, None] * bead_mask[cols][:, None, :]
        u = 1.0 - tb * rinv
        wu = wb * pv * u
        v = torch.clamp_min(weights.vdw_radius * rinv - 1.0, 0.0)
        nb = ((rows_g[:, :, None] - cols[:, None, :]).abs() >= 2).to(xT.dtype) * pv
        nv = nb * v
        e_blk = (s2 * (0.5 * weights.noe * (wu * u)
                       + 0.5 * weights.vdw * (nv * v))).sum((-2, -1))   # (B, Tl)
        e = e + ((1.0 if s == 0 else 2.0) * live * e_blk).sum(-1)
        c = (2.0 * weights.noe * wu - 2.0 * weights.vdw * nv) * live[:, None, None]
        f = c[..., None] * diff                                    # (B, Tl, TM, TM, 3)
        g[:, row_start:row_start + Lb] += f.sum(3).reshape(B, Lb, 3)
        if s > 0:   # the diagonal shell's rows already hold both ends
            g.index_add_(1, cols.reshape(-1), -f.sum(2).reshape(B, Lb, 3))
    return e, g.transpose(1, 2).contiguous()


def strip_tri_energy_grad_plain(
    xT: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor, row_start: int, tile: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B6 with the tile as an argument: the strip's shells of
    the round-robin pairing of (tile, tile) blocks, in the Pallas kernel's
    rsqrt-space algebra, one shell at a time. Strips (Lb, L) with
    bead_mask (L,) are one chromosome; strips (C, Lb, L) with masks (C, L)
    run each chromosome's B / C structures alone and stack the results in
    chromosome order. Returns (the strip's energy partials (B,), its share
    of the gradient (B, 3, L))."""
    strip_tri_energy_grad_plain.calls += 1
    C, n = _chromosome_axis(xT, target, bead_mask)
    if target.dim() == 2:
        return _strip_one_plain(xT, target, w, weights, bead_mask, row_start, tile)
    outs = [_strip_one_plain(xT[c * n:(c + 1) * n], target[c], w[c], weights,
                             bead_mask[c], row_start, tile) for c in range(C)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


strip_tri_energy_grad_plain.calls = 0


def strip_scratch_bytes(B: int, L: int, Lb: int, row_start: int = 0) -> int:
    """Bytes of B6's scratch (its partials and energy partials) for B
    structures in all on strips of Lb rows of length L, whatever the
    chromosomes: the buffers grow with the structures, not with C."""
    plan = strip_plan(B, L, Lb, row_start)
    return 4 * (math.prod(plan["part_shape"]) + math.prod(plan["e_part_shape"]))


def strip_tri_energy_grad(
    xT: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor, row_start: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6 for one shard: xT (B, 3, L) the whole ensemble, target and folded
    weight w the (Lb, L) strips of rows [row_start, row_start + Lb),
    bead_mask (L,); or, for C chromosomes of B / C structures each
    (chromosome-major), strips (C, Lb, L) and masks (C, L), one launch for
    all of them, chromosome c's outputs bitwise those of a call of its own.
    All float32 (the strips may both be bfloat16: pair_bf16) and
    contiguous on the shard's device; the tile
    (`strip_tile(Lb)`) must divide row_start and L. Returns (the strip's
    energy partials (B,), its share of the gradient (B, 3, L)); the shards'
    sums are the whole pair energy and gradient. CPU tensors run the plain
    twin; CUDA tensors launch csrc/exact_tri_strip.cu, whose partials land
    in a (B, 2S, 3, Lb) scratch buffer that its second kernel assembles in a
    fixed order (no atomics: equal inputs give equal bits)."""
    if xT.dim() != 3 or target.dim() not in (2, 3):
        raise ValueError(f"xT (B, 3, L) and (Lb, L) or (C, Lb, L) strips required, got "
                         f"{tuple(xT.shape)} and {tuple(target.shape)}")
    B, L = xT.shape[0], xT.shape[2]
    C, n = _chromosome_axis(xT, target, bead_mask)
    Lb = target.shape[-2]
    lead = () if target.dim() == 2 else (C,)
    dev = check_inputs({
        "xT": (xT, (B, 3, L)), "target": (target, (*lead, Lb, L), TILE_DTYPES),
        "w": (w, (*lead, Lb, L), TILE_DTYPES), "bead_mask": (bead_mask, (*lead, L)),
    })
    kind = tile_dtype(target, w)
    plan = strip_plan(n, L, Lb, row_start)
    tile = plan["tile"]
    if dev.type == "cpu":
        return strip_tri_energy_grad_plain(xT, target, w, weights, bead_mask,
                                           row_start, tile)
    lib = _build.load_library()
    part = torch.empty((B, *plan["part_shape"][1:]), dtype=torch.float32, device=dev)
    e_part = torch.empty((B, *plan["e_part_shape"][1:]), dtype=torch.float32, device=dev)
    gT = torch.empty_like(xT)
    e = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.entry(lib, "c3d_exact_tri_strip", kind)(
            xT.data_ptr(), target.data_ptr(), w.data_ptr(), bead_mask.data_ptr(),
            part.data_ptr(), e_part.data_ptr(), gT.data_ptr(), e.data_ptr(),
            C, n, L, row_start, Lb, tile, plan["bslice"], weights.noe, weights.vdw,
            weights.vdw_radius, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "c3d_exact_tri_strip")
    strip_tri_energy_grad.launches += 1
    strip_tri_energy_grad.launches_bf16 += kind == torch.bfloat16
    strip_tri_energy_grad.launches_tile64 += tile == 64
    return e, gT


trace.count_launches(strip_tri_energy_grad)
strip_tri_energy_grad.launches_bf16 = 0     # of them, on bf16 strips
strip_tri_energy_grad.launches_tile64 = 0   # of them, at tile 64: the swapped-patch body
