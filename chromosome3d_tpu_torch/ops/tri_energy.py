"""Kernel B3: the exact-restraint pair energy and gradient computed once
per unordered tile pair (csrc/exact_tri.cu), its plain PyTorch twin, and
the route rule that picks it.

Replaces chromosome3d_tpu/ops/pallas_energy.py `_kernel_exact_tri` (entry
`pallas_energy_grad_tri_batched`) and the frozen default of
`use_triangular`. It computes what B2 computes — exact-well NOE plus vdw
repel, the 1/2 ordered-pair energy convention — on round-robin tile shells
(see exact_tri.cu), and reads and writes the (B, 3, L) layout that kernel
B4 consumes, so the semi route's step pays no transposes. The tile is the
port's own (TILE = 64); nothing is padded at the public face.

`tri_energy_grad` runs the plain twin for CPU tensors and the CUDA kernel
for CUDA tensors, counting each in a plain integer on the function
(`tri_energy_grad.launches`, `tri_energy_grad_plain.calls`).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from chromosome3d_tpu_torch.ops import _build
from chromosome3d_tpu_torch.ops.energy import EnergyWeights
from chromosome3d_tpu_torch.ops.fused_step import fused_step_feasible
from chromosome3d_tpu_torch.ops.pair_energy import check_inputs, exact_rows_plain

TILE = 64                       # the kernel's tile edge (kTM in exact_tri.cu)
_PLAIN_CHUNK_ELEMS = 1 << 24    # the twin's (B, rows, L) temporaries per chunk
_THREADS, _WARPS = 256, 8       # tri_pair.cuh's block
_SLICE_MAX = 10                 # structures a slice: two blocks fit an SM


def tri_plan(B: int, L: int, Lb: int, tile: int, compact: bool = False) -> dict:
    """What the wrappers of the tile-pair body (csrc/tri_pair.cuh) decide on
    the host for B structures and a strip of Lb rows of length L (B3: Lb =
    L, ragged L allowed; B6: `compact`, tile divides Lb and L): one block
    per (row tile, shell), the structures through a block in slices of
    `bslice`, the block's shared memory and the scratch shapes. Raises
    ValueError past the card's shared memory."""
    Tg = -(-L // tile)
    Tl = -(-Lb // tile)
    S = Tg // 2 + 1
    bslice = -(-B // -(-B // _SLICE_MAX))
    smem = 4 * bslice * (2 * 2 * 3 * tile + _WARPS * 3 * max(tile, 16) + 3 * tile
                         + 2 * _WARPS)
    if smem > _build.SMEM_MAX:
        raise ValueError(
            f"tri_pair.cuh needs {smem} bytes of shared memory at tile {tile}; "
            f"a block can have at most {_build.SMEM_MAX}")
    width = Lb if compact else Tg * tile
    return {
        "threads": _THREADS, "tile": tile, "Tl": Tl, "Tg": Tg, "S": S,
        "blocks": Tl * S, "bslice": bslice, "smem_bytes": smem,
        "part_shape": (B, 2 * S, 3, width), "e_part_shape": (B, Tl * S),
    }


def tile_pairs(Tl: int, Tg: int, row0t: int = 0) -> List[Tuple[int, int, int, bool]]:
    """The body's blocks for a strip of Tl row tiles from global tile row0t:
    (row tile, column tile, shell, live) in grid order. A block that is not
    live is the even-Tg last shell's second meeting of a pair and adds
    nothing."""
    S = Tg // 2 + 1
    out = []
    for blk in range(Tl * S):
        ti, sh = blk % Tl, blk // Tl
        ig = row0t + ti
        live = not (Tg % 2 == 0 and sh == S - 1 and ig >= Tg // 2)
        out.append((ig, (ig + sh) % Tg, sh, live))
    return out


def use_triangular(L: int, for_unfused: bool = False) -> bool:
    """The JAX package's `use_triangular` with no dispatch table
    (pallas_energy.py:1266-1268, 1290-1292): B3 needs at least 3 tiles;
    for the pick and the other unfused callers it runs from L = 1024; on
    the annealing step only where the fused step B1 cannot run. Tests
    replace this function to force a route, as the JAX tests replace
    theirs."""
    if -(-max(L, 8) // TILE) < 3:
        return False
    if for_unfused:
        return L >= 1024
    return not fused_step_feasible(L)


def tri_energy_grad_plain(
    xT: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B3: B2's plain math (`exact_rows_plain`) over the whole
    pair matrix, in row chunks so the temporaries stay near 64 MiB each at
    the at-scale shape. Returns (pair energies (B,), gradients (B, 3, L))."""
    tri_energy_grad_plain.calls += 1
    B, _, L = xT.shape
    coords = xT.transpose(1, 2)
    rows = max(1, _PLAIN_CHUNK_ELEMS // (B * L))
    e = torch.zeros(B, dtype=xT.dtype, device=xT.device)
    gT = torch.empty_like(xT)
    for r0 in range(0, L, rows):
        r1 = min(r0 + rows, L)
        e_c, g_c = exact_rows_plain(coords, target, w, weights, bead_mask, r0, r1)
        e = e + e_c
        gT[:, :, r0:r1] = g_c.transpose(1, 2)
    return e, gT


tri_energy_grad_plain.calls = 0


def tri_energy_grad(
    xT: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3 for a batch sharing one restraint set: xT (B, 3, L), target and
    folded weight w (L, L), symmetric (as every restraint set of both
    packages is: the kernel takes each unordered pair's target and weight
    from its row tile), bead_mask (L,), all float32 and contiguous.
    Returns (pair energies (B,), pair gradients (B, 3, L)). CPU tensors run
    the plain twin; CUDA tensors launch csrc/exact_tri.cu, whose row and
    column partials land in a (B, 2S, 3, T * TILE) scratch buffer that a
    second kernel sums per bead in a fixed order (no atomics: equal inputs
    give equal bits)."""
    if xT.dim() != 3:
        raise ValueError(f"xT must be (B, 3, L), got {tuple(xT.shape)}")
    B, L = xT.shape[0], xT.shape[2]
    dev = check_inputs({
        "xT": (xT, (B, 3, L)), "target": (target, (L, L)), "w": (w, (L, L)),
        "bead_mask": (bead_mask, (L,)),
    })
    if B == 0 or L == 0:
        raise ValueError(f"empty batch: B={B}, L={L}")
    if dev.type == "cpu":
        return tri_energy_grad_plain(xT, target, w, weights, bead_mask)
    plan = tri_plan(B, L, L, TILE)
    lib = _build.load_library()
    part = torch.empty(plan["part_shape"], dtype=torch.float32, device=dev)
    e_part = torch.empty(plan["e_part_shape"], dtype=torch.float32, device=dev)
    gT = torch.empty_like(xT)
    e = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.c3d_exact_tri(
            xT.data_ptr(), target.data_ptr(), w.data_ptr(), bead_mask.data_ptr(),
            part.data_ptr(), e_part.data_ptr(), gT.data_ptr(), e.data_ptr(),
            B, L, plan["Tg"], TILE, plan["bslice"], weights.noe, weights.vdw,
            weights.vdw_radius,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "c3d_exact_tri")
    tri_energy_grad.launches += 1
    return e, gT


tri_energy_grad.launches = 0
