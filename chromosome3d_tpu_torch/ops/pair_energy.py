"""Kernel B2: exact-restraint pair energy + gradient (csrc/exact_pair.cu),
its plain PyTorch twin, and the batched value-and-grad built on it.

Replaces chromosome3d_tpu/ops/pallas_energy.py `_kernel_exact` (entry
`_pairwise_energy_grad_batched(..., exact=True)`) and
`pallas_energy_and_grad_batched`, which routes exact restraints to B3
(ops.tri_energy) where `use_triangular` says so (from L = 1024 with no
dispatch table) and general ones to B5 (ops.general_pair) as the JAX
package does. The solver calls it once per solve, for the enantiomer pick,
and once for a whole genome bucket (C chromosomes' tiles stacked, structure
b reading chromosome b / (B / C)'s: B2, B3 and B5 take that axis); on the unfused
route (solver.unfused) it is every step's value and gradient, with the
bond and angle terms (`bond_energy_grad`, the angle's gradient written out
in closed form). No autograd is involved: the kernel returns the exact
gradient and the solver consumes it directly.

Kernel B2' is the same body on one shard's rows of the row-sharded solve
(`exact_row_block_energy_grad`): it replaces `_kernel_exact` reached through
`pallas_row_block_energy_grad_batched(..., exact=True)`, with or without
the chromosome axis ((C, Lb, L) strips of a genome group).

The restraint tiles (target and w) may be float32 or bfloat16
(AnnealConfig.pair_bf16, as the JAX package's `bf16=` casts them): a CUDA
launch on bf16 tiles takes the kernel's bf16 entry point, which widens each
element on load, and the twins widen them on read; everything else is
float32. Each wrapper runs its plain twin for CPU tensors and the CUDA kernel for
CUDA tensors; each path counts its calls in a plain integer on the function
(`exact_pair_energy_grad.launches`, `exact_pair_energy_grad_plain.calls`,
`exact_row_block_energy_grad.launches`,
`exact_row_block_energy_grad_plain.calls`), so a run can show which one it
took; `.launches_bf16` counts the launches of the bf16 entry point.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from chromosome3d_tpu_torch.ops import _build
from chromosome3d_tpu_torch.ops.energy import (
    _EPS,
    EnergyWeights,
    ExactRestraints,
    _angle_energy,
)


# what the exact kernels' restraint tiles may be: float32, or bfloat16
# (AnnealConfig.pair_bf16), widened on load; every other input is float32
TILE_DTYPES = (torch.float32, torch.bfloat16)


def exact_pair_tiles(restraints):
    """(target, folded weight) for the exact kernels: aliases of the stored
    tensors for ExactRestraints, one fold (lo, mask * weight) otherwise."""
    if isinstance(restraints, ExactRestraints):
        return restraints.target, restraints.w
    return restraints.lo, restraints.mask * restraints.weight


def check_inputs(specs) -> torch.device:
    """The wrappers' contract for {name: (tensor, expected shape[,
    dtypes])}: a dtype of `dtypes` (float32 where none are given),
    contiguous, one device, exact shapes. Returns the common device."""
    dev = next(iter(specs.values()))[0].device
    for name, (x, shape, *allowed) in specs.items():
        dtypes = allowed[0] if allowed else (torch.float32,)
        if x.dtype not in dtypes:
            want = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"{name}: {want} required, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def tile_dtype(*tiles: torch.Tensor) -> torch.dtype:
    """The one dtype of a kernel's restraint tiles (check_inputs has
    admitted each): a launch reads all of them as float32 or all as
    bfloat16, so a mix raises TypeError."""
    kinds = {t.dtype for t in tiles}
    if len(kinds) != 1:
        raise TypeError(f"restraint tiles of one dtype required, got {sorted(map(str, kinds))}")
    return kinds.pop()


def as_tile_dtype(tiles, bf16: bool):
    """Tiles as the kernels read them: cast to contiguous bfloat16 when bf16
    (AnnealConfig.pair_bf16 on an exact route; a no-op for tiles stored
    bf16), as they are otherwise."""
    if not bf16:
        return tuple(tiles)
    return tuple(t.to(torch.bfloat16).contiguous() for t in tiles)


def exact_rows_plain(
    coords: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor, r0: int, r1: int,
    row_start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `_kernel_exact` math for rows [r0, r1) of the pair matrix of
    (B, L, 3) coords: returns (the rows' pair energies summed (B,), their
    gradients (B, r1 - r0, 3)). target and w hold the matrix's rows from
    row_start on (the whole matrix, or one shard's strip). The gradient is
    summed as sum_j c_ij (x_i - x_j), like the kernels (see exact_pair.cu).
    bfloat16 tiles are widened as the rows are read."""
    x = coords
    L = x.shape[1]
    target = target[r0 - row_start:r1 - row_start].float()
    w = w[r0 - row_start:r1 - row_start].float()
    diffs = [x[:, r0:r1, c, None] - x[:, None, :, c] for c in range(3)]
    d2 = torch.zeros(x.shape[0], r1 - r0, L, dtype=x.dtype, device=x.device)
    for diff in diffs:
        d2 = d2 + diff * diff
    rinv = torch.rsqrt(d2 + _EPS)
    d = (d2 + _EPS) * rinv
    pair_valid = bead_mask[r0:r1, None] * bead_mask[None, :]
    wv = w * pair_valid
    dev = d - target
    e_noe = 0.5 * weights.noe * (wv * dev * dev).sum(-1)
    c_noe = weights.noe * wv * (2.0 * dev)
    idx = torch.arange(L, device=x.device)
    nonbonded = ((idx[r0:r1, None] - idx[None, :]).abs() >= 2).to(x.dtype) * pair_valid
    overlap = torch.clamp_min(weights.vdw_radius - d, 0.0)
    e_vdw = 0.5 * weights.vdw * (nonbonded * overlap * overlap).sum(-1)
    c = (c_noe - 2.0 * weights.vdw * nonbonded * overlap) * rinv
    g = torch.stack([(c * diff).sum(-1) for diff in diffs], dim=-1)
    return (e_noe + e_vdw).sum(-1), g


def exact_pair_energy_grad_plain(
    coords: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B2, the `_kernel_exact` math for (B, L, 3) coords:
    returns (pair energies (B,), pair gradients (B, L, 3)). With (C, L, L)
    tiles and (C, L) bead masks each chromosome's B / C structures are
    evaluated alone, in chromosome order."""
    exact_pair_energy_grad_plain.calls += 1
    L = coords.shape[1]
    if target.dim() == 2:
        return exact_rows_plain(coords, target, w, weights, bead_mask, 0, L)
    n = coords.shape[0] // target.shape[0]
    outs = [exact_rows_plain(coords[c * n:(c + 1) * n], target[c], w[c], weights,
                             bead_mask[c], 0, L) for c in range(target.shape[0])]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


exact_pair_energy_grad_plain.calls = 0


_ROWS_BLOCK = 8       # csrc/exact_pair.cu: a warp a row, 8 rows a block
_STAGE_MAX = 2048    # block energies its last block stages in shared memory


def exact_pair_plan(B: int, L: int, Lb: int) -> dict:
    """csrc/exact_pair.cu's grid for B structures and the Lb rows of an (Lb,
    L) strip (B2: Lb = L): (row groups of 8 rows, one a warp, B structures).
    A warp's lanes stride all L columns of its row, so a row meets its
    columns in the same order in B2 and in B2'. The last block sums the
    (B, row groups) block energies, staged in shared memory when they fit
    (read through L2 otherwise)."""
    if B < 1 or Lb < 1 or L < Lb:
        raise ValueError(f"empty or bad strip: B={B}, Lb={Lb}, L={L}")
    groups = -(-Lb // _ROWS_BLOCK)
    return {"rows_block": _ROWS_BLOCK, "row_groups": groups, "blocks": groups * B,
            "e_part_shape": (B, groups), "staged": B * groups <= _STAGE_MAX}


def _launch_exact(xT, target, w, weights, bead_mask, row_start, dev):
    """csrc/exact_pair.cu on the rows the (Lb, L) tiles hold, or on C
    chromosomes' (C, Lb, L) tiles and (C, L) bead masks: (energies (B,),
    gradient rows (B, 3, Lb)), one launch of the entry point for the tiles'
    dtype (float32 or bfloat16; the plan is the same)."""
    B, L = xT.shape[0], xT.shape[2]
    Lb = target.shape[-2]
    n_per = B // (target.shape[0] if target.dim() == 3 else 1)
    lib = _build.load_library()
    e = torch.empty((B,), dtype=torch.float32, device=dev)
    gT = torch.empty((B, 3, Lb), dtype=torch.float32, device=dev)
    n_part = B * exact_pair_plan(B, L, Lb)["row_groups"]
    e_part = _build.workspace(dev, "exact_pair e_part", n_part, torch.float32)
    ticket = _build.workspace(dev, "exact_pair ticket", 1)
    with torch.cuda.device(dev):
        err = _build.entry(lib, "c3d_exact_pair", tile_dtype(target, w))(
            xT.data_ptr(), target.data_ptr(), w.data_ptr(), bead_mask.data_ptr(),
            gT.data_ptr(), e.data_ptr(), e_part.data_ptr(), ticket.data_ptr(), B, L,
            row_start, Lb, n_per, weights.noe, weights.vdw, weights.vdw_radius,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "c3d_exact_pair")
    return e, gT


def exact_pair_energy_grad(
    coords: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2 for a batch sharing one restraint set: coords (B, L, 3), target and
    folded weight w (L, L), bead_mask (L,), all float32 and contiguous
    (target and w may both be bfloat16: pair_bf16); or
    for C chromosomes of B / C structures each, chromosome-major, with
    target and w (C, L, L) and bead_mask (C, L) — a genome bucket's pick in
    one launch, each chromosome's rows bitwise those of a launch of its own.
    Returns (pair energies (B,), pair gradients (B, L, 3)). CPU tensors run
    the plain twin; CUDA tensors launch csrc/exact_pair.cu on the (B, 3, L)
    layout (the pick's one call a solve transposes in, and returns the
    gradient as a (B, L, 3) view)."""
    if coords.dim() != 3:
        raise ValueError(f"coords must be (B, L, 3), got {tuple(coords.shape)}")
    B, L = coords.shape[0], coords.shape[1]
    lead = () if target.dim() == 2 else (target.shape[0],)
    if lead and B % lead[0]:
        raise ValueError(f"{B} structures do not divide over {lead[0]} chromosomes")
    dev = check_inputs({
        "coords": (coords, (B, L, 3)), "target": (target, (*lead, L, L), TILE_DTYPES),
        "w": (w, (*lead, L, L), TILE_DTYPES), "bead_mask": (bead_mask, (*lead, L)),
    })
    tile_dtype(target, w)
    if B == 0 or L == 0:
        raise ValueError(f"empty batch: B={B}, L={L}")
    if dev.type == "cpu":
        return exact_pair_energy_grad_plain(coords, target, w, weights, bead_mask)
    e, gT = _launch_exact(coords.transpose(1, 2).contiguous(), target, w, weights,
                          bead_mask, 0, dev)
    exact_pair_energy_grad.launches += 1
    exact_pair_energy_grad.launches_bf16 += target.dtype == torch.bfloat16
    return e, gT.transpose(1, 2)


exact_pair_energy_grad.launches = 0
exact_pair_energy_grad.launches_bf16 = 0   # of them, on bf16 tiles


def exact_row_block_energy_grad_plain(
    xT: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor, row_start: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B2': the `_kernel_exact` math for the rows
    [row_start, row_start + Lb) that the (Lb, L) strips hold. Returns (the
    strip's pair energies (B,), its gradient rows (B, 3, Lb)). With (C, Lb,
    L) strips and (C, L) bead masks each chromosome's B / C structures are
    evaluated alone, in chromosome order."""
    exact_row_block_energy_grad_plain.calls += 1
    Lb = target.shape[-2]

    def rows(xT_c, t_c, w_c, bm_c):
        e, g = exact_rows_plain(xT_c.transpose(1, 2), t_c, w_c, weights, bm_c,
                                row_start, row_start + Lb, row_start)
        return e, g.transpose(1, 2).contiguous()

    if target.dim() == 2:
        return rows(xT, target, w, bead_mask)
    n = xT.shape[0] // target.shape[0]
    outs = [rows(xT[c * n:(c + 1) * n], target[c], w[c], bead_mask[c])
            for c in range(target.shape[0])]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


exact_row_block_energy_grad_plain.calls = 0


def exact_row_block_energy_grad(
    xT: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor, row_start: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2' for one shard: xT (B, 3, L) the whole ensemble, target and folded
    weight w the (Lb, L) strips of rows [row_start, row_start + Lb),
    bead_mask (L,), all float32 and contiguous on the shard's device (the
    strips may both be bfloat16: pair_bf16); or
    for C chromosomes of B / C structures each, chromosome-major, with (C,
    Lb, L) strips and (C, L) bead masks — a genome group's rows in one
    launch, each chromosome's outputs bitwise those of a launch of its own
    at the same row_start. Returns (the strip's pair energies (B,), its
    gradient rows (B, 3, Lb)), the layout kernel B4 reads. CUDA tensors make
    one launch of csrc/exact_pair.cu, which reads xT and writes both outputs
    itself; CPU tensors run the plain twin."""
    if xT.dim() != 3 or target.dim() not in (2, 3):
        raise ValueError(f"xT (B, 3, L) and (Lb, L) or (C, Lb, L) strips required, got "
                         f"{tuple(xT.shape)} and {tuple(target.shape)}")
    B, L = xT.shape[0], xT.shape[2]
    Lb = target.shape[-2]
    lead = tuple(target.shape[:-2])
    if lead and (lead[0] == 0 or B % lead[0]):
        raise ValueError(f"{B} structures do not divide over {lead[0]} chromosomes")
    dev = check_inputs({
        "xT": (xT, (B, 3, L)), "target": (target, (*lead, Lb, L), TILE_DTYPES),
        "w": (w, (*lead, Lb, L), TILE_DTYPES), "bead_mask": (bead_mask, (*lead, L)),
    })
    tile_dtype(target, w)
    if B == 0 or Lb == 0 or not 0 <= row_start <= L - Lb:
        raise ValueError(f"bad strip: B={B}, rows [{row_start}, {row_start + Lb}) of {L}")
    if dev.type == "cpu":
        return exact_row_block_energy_grad_plain(xT, target, w, weights, bead_mask,
                                                 row_start)
    e, gT = _launch_exact(xT, target, w, weights, bead_mask, row_start, dev)
    exact_row_block_energy_grad.launches += 1
    exact_row_block_energy_grad.launches_bf16 += target.dtype == torch.bfloat16
    return e, gT


exact_row_block_energy_grad.launches = 0
exact_row_block_energy_grad.launches_bf16 = 0   # of them, on bf16 tiles


def _angle_grad(bond_vec, bond_d, bond_valid, angle: float):
    """dE/d(bond vector) of ops.energy._angle_energy, (B, L-1, 3): for each
    consecutive pair (p, q) of bonds with lengths dp, dq (the bond_d that
    carries _EPS) and cos = p.q / (dp dq), d cos/dp = q / (dp dq) - cos p /
    dp^2 and d cos/dq = p / (dp dq) - cos q / dq^2, times -angle and the
    pair's validity (0 where a bond reaches a padded bead)."""
    p, q = bond_vec[..., :-1, :], bond_vec[..., 1:, :]
    dp, dq = bond_d[..., :-1], bond_d[..., 1:]
    dpq = dp * dq
    cos = (p * q).sum(-1) / dpq
    s = (-angle * (bond_valid[..., :-1] * bond_valid[..., 1:]))[..., None]
    g_p = s * (q / dpq[..., None] - cos[..., None] * p / (dp * dp)[..., None])
    g_q = s * (p / dpq[..., None] - cos[..., None] * q / (dq * dq)[..., None])
    return F.pad(g_p, (0, 0, 0, 1)) + F.pad(g_q, (0, 0, 1, 0))


def bond_energy_grad(coords: torch.Tensor, weights: EnergyWeights,
                     bead_mask: torch.Tensor):
    """Chain-bond energies (B,) and their exact gradient (B, L, 3) — the
    JAX package's `_bond_energy` (bond + the optional angle term,
    ops.energy._angle_energy) and its autodiff gradient, written out.
    bead_mask (L,) serves every structure; (B, L) gives each its own. At
    angle 0 the angle term is not computed at all."""
    bond_vec = coords[:, 1:] - coords[:, :-1]
    bond_d = torch.sqrt((bond_vec * bond_vec).sum(-1) + _EPS)
    bond_valid = bead_mask[..., 1:] * bead_mask[..., :-1]
    bdev = bond_d - weights.bond_length
    e = weights.bond * (bond_valid * bdev * bdev).sum(-1)
    f = (2.0 * weights.bond * bond_valid * bdev / bond_d)[..., None] * bond_vec
    if weights.angle != 0.0:
        e = e + _angle_energy(bond_vec, bond_d, bond_valid, weights)
        f = f + _angle_grad(bond_vec, bond_d, bond_valid, weights.angle)
    # dE/dx_i = f_{i-1} (x_i is bond i-1's far end) - f_i (bond i's base)
    g = F.pad(f, (0, 0, 1, 0)) - F.pad(f, (0, 0, 0, 1))
    return e, g


def bond_energy_grad_stacked(coords: torch.Tensor, weights: EnergyWeights,
                             bead_masks: torch.Tensor):
    """bond_energy_grad for C chromosomes of B / C structures each,
    chromosome-major, with (C, L) bead masks: one call a chromosome on its
    own (B / C, L, 3) slice, so each chromosome's energies are those of a
    solve of its own (the card's sum over the bonds is ordered by the
    batch's size). An (L,) mask is one call for the batch."""
    if bead_masks.dim() == 1:
        return bond_energy_grad(coords, weights, bead_masks)
    C = bead_masks.shape[0]
    n = coords.shape[0] // C
    parts = [bond_energy_grad(coords[c * n:(c + 1) * n], weights, bead_masks[c])
             for c in range(C)]
    if C == 1:
        return parts[0]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def pair_energy_and_grad_batched(
    coords: torch.Tensor, restraints, weights: EnergyWeights,
    bead_mask: torch.Tensor, exact: bool = True, tiles=None, tri=None,
    bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Value and gradient for a shared-restraint batch: a pair kernel plus
    the chain bond (and the angle term where weights.angle is not 0).
    Counterpart of the JAX package's
    `pallas_energy_and_grad_batched(..., exact=exact)` with its dispatch
    (`_pairwise_energy_grad_batched`): exact restraints take the triangular
    kernel B3 where `tri_energy.use_triangular(L, for_unfused=True,
    batch=B / C)` holds on the coordinates' device and the whole-matrix
    kernel B2 otherwise; general restraints take B5 (there is no triangular
    variant of the general well); exact=True reads lo as the target.
    Restraints of (C, L, L) tensors with bead_mask (C, L) hold C chromosomes
    of B / C structures each, chromosome-major (a genome bucket's pick),
    and the table is asked with a chromosome's B / C, as the JAX package's
    call under the genome vmap asks with its own. tiles: the kernel's tiles folded
    once by the caller (pair_tiles), for a loop that calls this every step.
    tri: None lets use_triangular decide; True or False pins B3 or B2 (a
    solve decides once, as the JAX package's trace does; False is its
    static no_tri=True). bf16: the exact kernels read bfloat16 tiles (the
    JAX package's bf16=, AnnealConfig.pair_bf16 on an exact route; ignored
    for general restraints, as there). Returns (energies (B,), gradients
    (B, L, 3))."""
    # imported here: both build on this module
    from chromosome3d_tpu_torch.ops import general_pair, tri_energy

    L = coords.shape[1]
    if exact and tri is None:
        n_per = coords.shape[0] // (bead_mask.shape[0] if bead_mask.dim() == 2 else 1)
        tri = tri_energy.use_triangular(L, for_unfused=True, batch=n_per,
                                        device=coords.device)
    if tiles is None:
        tiles = pair_tiles(restraints, exact, bf16)
    if not exact:
        e_pair, gT = general_pair.general_pair_energy_grad(
            coords.transpose(1, 2).contiguous(), *tiles, weights, bead_mask,
        )
        g_pair = gT.transpose(1, 2)
    elif tri:
        e_pair, gT = tri_energy.tri_energy_grad(
            coords.transpose(1, 2).contiguous(), *tiles, weights, bead_mask
        )
        g_pair = gT.transpose(1, 2)
    else:
        e_pair, g_pair = exact_pair_energy_grad(coords, *tiles, weights, bead_mask)
    e_bond, g_bond = bond_energy_grad_stacked(coords, weights, bead_mask)
    return e_pair + e_bond, g_pair + g_bond


def pair_tiles(restraints, exact: bool = True, bf16: bool = False):
    """The tiles pair_energy_and_grad_batched's kernels read, contiguous:
    (target, folded w) for exact restraints, as bfloat16 under bf16 (the
    JAX package's `bf16=`: a cast of the float32 tiles, none for tiles
    stored bf16), (lo, hi, folded w) else (no bf16 form: the general well
    ignores the flag, as the JAX package's does)."""
    # imported here: general_pair builds on this module
    from chromosome3d_tpu_torch.ops import general_pair

    if not exact:
        return general_pair.general_pair_tiles(restraints)
    return as_tile_dtype((a.contiguous() for a in exact_pair_tiles(restraints)), bf16)
