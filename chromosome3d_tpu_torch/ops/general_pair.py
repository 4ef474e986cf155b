"""Kernel B5: general-restraint pair energy + gradient (csrc/general_pair.cu)
and its plain PyTorch twin.

Replaces chromosome3d_tpu/ops/pallas_energy.py `_kernel` (entry
`_pairwise_energy_grad_batched(..., exact=False)`): the soft-square
flat-bottom well on [lo, hi] with linear tails past noe_rswitch, plus the
vdw repel, the 1/2 ordered-pair energy convention. It reads and writes the
(B, 3, L) layout kernel B4 consumes, so the semi-general step pays no
transposes; the tiles (lo, hi, w = mask * weight) are folded once per solve
(`general_pair_tiles`).

Kernel B5 takes a chromosome axis: a genome bucket's C chromosomes of B
structures each, tiles and a bead mask each, in one launch a batch slice,
each chromosome's bits those of a launch of its own (the JAX runner's vmap
of the solve over its bucket).

Kernel B5' is the same body on one shard's rows of the row-sharded solve
(`general_row_block_energy_grad`): it replaces `_kernel` reached through
`pallas_row_block_energy_grad_batched(..., exact=False)`, reads (Lb, L)
strips of the tiles and writes the strip's gradient rows. It takes the
chromosome axis too: (C, Lb, L) strips of a genome group's C chromosomes
(the JAX package's vmap of the row block under its chrom x beads solve),
each chromosome's rows bitwise a launch of its own at the same row_start.

Each wrapper runs its plain twin for CPU tensors and the CUDA kernel for
CUDA tensors, counting each in a plain integer on the function
(`general_pair_energy_grad.launches`, `general_pair_energy_grad_plain.calls`,
`general_row_block_energy_grad.launches`,
`general_row_block_energy_grad_plain.calls`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from chromosome3d_tpu_torch.ops import _build
from chromosome3d_tpu_torch.ops.energy import _EPS, EnergyWeights
from chromosome3d_tpu_torch.ops.pair_energy import check_inputs

_PLAIN_CHUNK_ELEMS = 1 << 24    # the twin's (B, rows, L) temporaries per chunk
# general_pair.cu's block: 8 warps of 4 rows each, 128-column chunks, 13 sums
# per warp and structure
_THREADS, _WARPS, _ROWS_BLOCK, _CHUNK, _VALS = 256, 8, 32, 128, 13
_BATCH_MAX = 24                 # structures a launch: two blocks fit an SM
_SPLITS_MAX = 40                # column splits: one chunk each up to L = 5120


def general_pair_plan(B: int, L: int, Lb: int) -> dict:
    """What the wrapper decides on the host for B structures and the Lb rows
    of an (Lb, L) strip (B5: Lb = L): a grid of (row groups of 32 rows,
    column splits of `cps` 128-column chunks), the structures in launches of
    `bslice`, the shared memory of a block and the scratch shapes. The
    column split is a function of L alone, so a row meets the same columns
    in the same order in B5 and in B5'; the shared memory does not grow
    with L. Raises ValueError past the card's shared memory."""
    nchunks = -(-L // _CHUNK)
    cps = -(-nchunks // _SPLITS_MAX)
    nsplit = -(-nchunks // cps)
    groups = -(-Lb // _ROWS_BLOCK)
    launches = -(-B // _BATCH_MAX)
    bslice = -(-B // launches)
    smem = 4 * bslice * (2 * 3 * _CHUNK + 3 * _ROWS_BLOCK + _WARPS * _VALS)
    if smem > _build.SMEM_MAX:
        raise ValueError(
            f"general_pair.cu needs {smem} bytes of shared memory at B={B}; "
            f"a block can have at most {_build.SMEM_MAX}")
    return {
        "threads": _THREADS, "rows_block": _ROWS_BLOCK, "chunk": _CHUNK,
        "cps": cps, "nsplit": nsplit, "row_groups": groups,
        "blocks": groups * nsplit, "bslice": bslice, "launches": launches,
        "smem_bytes": smem, "part_shape": (B, nsplit, 3, Lb),
        "e_part_shape": (B, groups * nsplit),
    }


def plan_rows(plan: dict, group: int, Lb: int) -> range:
    """The strip rows block row `group` of the grid computes."""
    return range(group * plan["rows_block"], min(Lb, (group + 1) * plan["rows_block"]))


def plan_cols(plan: dict, split: int, L: int) -> range:
    """The columns block column `split` of the grid sweeps, in order."""
    width = plan["cps"] * plan["chunk"]
    return range(split * width, min(L, (split + 1) * width))


def general_pair_tiles(restraints):
    """(lo, hi, w = mask * weight) as contiguous tensors: the fold the
    kernel reads, made once per solve."""
    return (restraints.lo.contiguous(), restraints.hi.contiguous(),
            (restraints.mask * restraints.weight).contiguous())


def general_rows_plain(
    coords: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor, r0: int, r1: int,
    row_start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `_kernel` math for rows [r0, r1) of the pair matrix of (B, L, 3)
    coords: returns (the rows' pair energies summed (B,), their gradients
    (B, r1 - r0, 3)). lo, hi and w hold the matrix's rows from row_start on
    (the whole matrix, or one shard's strip). The gradient is summed as
    sum_j c_ij (x_i - x_j), like the kernel (see general_pair.cu)."""
    x = coords
    L = x.shape[1]
    lo, hi, w = (a[r0 - row_start:r1 - row_start] for a in (lo, hi, w))
    diffs = [x[:, r0:r1, c, None] - x[:, None, :, c] for c in range(3)]
    d2 = torch.zeros(x.shape[0], r1 - r0, L, dtype=x.dtype, device=x.device)
    for diff in diffs:
        d2 = d2 + diff * diff
    rinv = torch.rsqrt(d2 + _EPS)
    d = (d2 + _EPS) * rinv
    pair_valid = bead_mask[r0:r1, None] * bead_mask[None, :]
    wv = w * pair_valid
    over = torch.clamp_min(d - hi, 0.0)
    under = torch.clamp_min(lo - d, 0.0)
    viol = over + under
    rs = weights.noe_rswitch
    quad = viol <= rs
    well = torch.where(quad, viol * viol, rs * rs + 2.0 * rs * (viol - rs))
    dwell = torch.where(quad, 2.0 * viol, torch.full_like(viol, 2.0 * rs))
    sgn = torch.where(over > 0.0, 1.0, torch.where(under > 0.0, -1.0, 0.0))
    e_noe = 0.5 * weights.noe * (wv * well).sum(-1)
    c_noe = weights.noe * wv * dwell * sgn
    idx = torch.arange(L, device=x.device)
    nonbonded = ((idx[r0:r1, None] - idx[None, :]).abs() >= 2).to(x.dtype) * pair_valid
    overlap = torch.clamp_min(weights.vdw_radius - d, 0.0)
    e_vdw = 0.5 * weights.vdw * (nonbonded * overlap * overlap).sum(-1)
    c = (c_noe - 2.0 * weights.vdw * nonbonded * overlap) * rinv
    g = torch.stack([(c * diff).sum(-1) for diff in diffs], dim=-1)
    return (e_noe + e_vdw).sum(-1), g


def _rows_chunked(xT, lo, hi, w, weights, bead_mask, row_start):
    """general_rows_plain over every row the (Lb, L) tiles hold, in chunks
    so the temporaries stay near 64 MiB each at L = 5120. Returns (energies
    (B,), gradient rows (B, 3, Lb))."""
    B, _, L = xT.shape
    Lb = lo.shape[0]
    coords = xT.transpose(1, 2)
    rows = max(1, _PLAIN_CHUNK_ELEMS // (B * L))
    e = torch.zeros(B, dtype=xT.dtype, device=xT.device)
    gT = torch.empty((B, 3, Lb), dtype=xT.dtype, device=xT.device)
    for r0 in range(0, Lb, rows):
        r1 = min(r0 + rows, Lb)
        e_c, g_c = general_rows_plain(coords, lo, hi, w, weights, bead_mask,
                                      row_start + r0, row_start + r1, row_start)
        e = e + e_c
        gT[:, :, r0:r1] = g_c.transpose(1, 2)
    return e, gT


def general_pair_energy_grad_plain(
    xT: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B5: the `_kernel` math over the whole pair matrix, in
    row chunks. Returns (pair energies (B,), gradients (B, 3, L)). With
    (C, L, L) tiles and (C, L) bead masks each chromosome's B / C structures
    are evaluated alone, in chromosome order."""
    general_pair_energy_grad_plain.calls += 1
    if lo.dim() == 2:
        return _rows_chunked(xT, lo, hi, w, weights, bead_mask, 0)
    n = xT.shape[0] // lo.shape[0]
    outs = [_rows_chunked(xT[c * n:(c + 1) * n], lo[c], hi[c], w[c], weights, bead_mask[c], 0)
            for c in range(lo.shape[0])]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


general_pair_energy_grad_plain.calls = 0


def _launch(xT, lo, hi, w, weights, bead_mask, row_start, dev):
    """csrc/general_pair.cu on the rows the (Lb, L) tiles hold, or on C
    chromosomes' (C, L, L) tiles and (C, L) bead masks: (energies (B,),
    gradient rows (B, 3, Lb))."""
    B, L = xT.shape[0], xT.shape[2]
    Lb = lo.shape[-2]
    C = 1 if lo.dim() == 2 else lo.shape[0]
    plan = general_pair_plan(B // C, L, Lb)
    lib = _build.load_library()
    part = torch.empty((B, *plan["part_shape"][1:]), dtype=torch.float32, device=dev)
    e_part = torch.empty((B, plan["e_part_shape"][1]), dtype=torch.float32, device=dev)
    e = torch.empty((B,), dtype=torch.float32, device=dev)
    gT = torch.empty((B, 3, Lb), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.c3d_general_pair(
            xT.data_ptr(), lo.data_ptr(), hi.data_ptr(), w.data_ptr(),
            bead_mask.data_ptr(), part.data_ptr(), e_part.data_ptr(), e.data_ptr(),
            gT.data_ptr(), C, B // C, L, row_start, Lb, plan["cps"], plan["bslice"],
            weights.noe, weights.vdw, weights.vdw_radius, weights.noe_rswitch,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "c3d_general_pair")
    return e, gT


def general_pair_energy_grad(
    xT: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5 for a batch sharing one restraint set: xT (B, 3, L), the tiles lo,
    hi and folded weight w (L, L), bead_mask (L,), all float32 and
    contiguous; or for C chromosomes of B / C structures each,
    chromosome-major, with (C, L, L) tiles and (C, L) bead masks — a genome
    bucket in one launch a batch slice, each chromosome's outputs bitwise
    those of a launch of its own. Returns (pair energies (B,), pair
    gradients (B, 3, L)). CPU tensors run the plain twin; CUDA tensors
    launch csrc/general_pair.cu, whose block partials a second kernel sums
    in a fixed order (no atomics: equal inputs give equal bits)."""
    if xT.dim() != 3:
        raise ValueError(f"xT must be (B, 3, L), got {tuple(xT.shape)}")
    B, L = xT.shape[0], xT.shape[2]
    lead = () if lo.dim() == 2 else (lo.shape[0],)
    C = lead[0] if lead else 1
    if C == 0 or B % C:
        raise ValueError(f"{B} structures do not divide over {C} chromosomes")
    dev = check_inputs({
        "xT": (xT, (B, 3, L)), "lo": (lo, (*lead, L, L)), "hi": (hi, (*lead, L, L)),
        "w": (w, (*lead, L, L)), "bead_mask": (bead_mask, (*lead, L)),
    })
    if B == 0 or L == 0:
        raise ValueError(f"empty batch: B={B}, L={L}")
    if dev.type == "cpu":
        return general_pair_energy_grad_plain(xT, lo, hi, w, weights, bead_mask)
    e, gT = _launch(xT, lo, hi, w, weights, bead_mask, 0, dev)
    general_pair_energy_grad.launches += 1
    return e, gT


general_pair_energy_grad.launches = 0


def general_row_block_energy_grad_plain(
    xT: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor, row_start: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B5': the `_kernel` math for the rows [row_start,
    row_start + Lb) that the (Lb, L) strips lo, hi and w hold, in row chunks.
    Returns (the strip's pair energies (B,), its gradient rows (B, 3, Lb)).
    With (C, Lb, L) strips and (C, L) bead masks each chromosome's B / C
    structures are evaluated alone, in chromosome order."""
    general_row_block_energy_grad_plain.calls += 1
    if lo.dim() == 2:
        return _rows_chunked(xT, lo, hi, w, weights, bead_mask, row_start)
    n = xT.shape[0] // lo.shape[0]
    outs = [_rows_chunked(xT[c * n:(c + 1) * n], lo[c], hi[c], w[c], weights, bead_mask[c],
                          row_start) for c in range(lo.shape[0])]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


general_row_block_energy_grad_plain.calls = 0


def general_row_block_energy_grad(
    xT: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor, row_start: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5' for one shard: xT (B, 3, L) the whole ensemble, lo, hi and the
    folded weight w the (Lb, L) strips of rows [row_start, row_start + Lb),
    bead_mask (L,), all float32 and contiguous on the shard's device; or
    for C chromosomes of B / C structures each, chromosome-major, with (C,
    Lb, L) strips and (C, L) bead masks — a genome group's rows in one
    launch a batch slice, each chromosome's outputs bitwise those of a
    launch of its own at the same row_start (the plan is a function of a
    chromosome's B / C structures and L). Returns (the strip's pair energies
    (B,), its gradient rows (B, 3, Lb)). CPU tensors run the plain twin;
    CUDA tensors launch csrc/general_pair.cu with the row offset."""
    if xT.dim() != 3 or lo.dim() not in (2, 3):
        raise ValueError(f"xT (B, 3, L) and (Lb, L) or (C, Lb, L) strips required, got "
                         f"{tuple(xT.shape)} and {tuple(lo.shape)}")
    B, L = xT.shape[0], xT.shape[2]
    Lb = lo.shape[-2]
    lead = tuple(lo.shape[:-2])
    if lead and (lead[0] == 0 or B % lead[0]):
        raise ValueError(f"{B} structures do not divide over {lead[0]} chromosomes")
    dev = check_inputs({
        "xT": (xT, (B, 3, L)), "lo": (lo, (*lead, Lb, L)), "hi": (hi, (*lead, Lb, L)),
        "w": (w, (*lead, Lb, L)), "bead_mask": (bead_mask, (*lead, L)),
    })
    if B == 0 or Lb == 0 or not 0 <= row_start <= L - Lb:
        raise ValueError(f"bad strip: B={B}, rows [{row_start}, {row_start + Lb}) of {L}")
    if dev.type == "cpu":
        return general_row_block_energy_grad_plain(xT, lo, hi, w, weights, bead_mask,
                                                   row_start)
    e, gT = _launch(xT, lo, hi, w, weights, bead_mask, row_start, dev)
    general_row_block_energy_grad.launches += 1
    return e, gT


general_row_block_energy_grad.launches = 0
