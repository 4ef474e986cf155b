"""Kernel B3: the exact-restraint pair energy and gradient computed once
per unordered tile pair (csrc/exact_tri.cu), its plain PyTorch twin, and
the route rule that picks it, with the measured dispatch table it reads.

Replaces chromosome3d_tpu/ops/pallas_energy.py `_kernel_exact_tri` (entry
`pallas_energy_grad_tri_batched`) and `use_triangular` with its table
reader (`_dispatch_sources`, here one file: `_dispatch_source`;
`_active_dispatch`, `_select_dispatch_entry`, `_entry_seconds`,
`describe_dispatch`). It computes what B2 computes —
exact-well NOE plus vdw repel, the 1/2 ordered-pair energy convention — on
round-robin tile shells (see exact_tri.cu), and reads and writes the (B, 3,
L) layout that kernel B4 consumes, so the semi route's step pays no
transposes. The tile is the port's own (TILE = 64); nothing is padded at
the public face. It takes a chromosome axis: a genome bucket's C
chromosomes of B structures each, tiles and a bead mask each, in one
launch, each chromosome's bits those of a launch of its own.

The dispatch table (written by ops.calibrate, `calibrate` on the CLI) is
the JAX package's format, keyed by device kind (`torch.cuda.get_device_name`
on the card, "cpu" on the CPU): `CHROM3D_DISPATCH_TABLE` alone when it is
set, else the port's user cache ~/.cache/chromosome3d_torch/dispatch.json
(its seconds are of the port's kernels, so it is not the JAX package's
file). No table is shipped. With no table the frozen defaults decide, and
`CHROM3D_NO_TRI` set turns the triangular kernel off.

`tri_energy_grad` runs the plain twin for CPU tensors and the CUDA kernel
for CUDA tensors (on float32 or, under AnnealConfig.pair_bf16, bfloat16
target and w tiles: the bf16 entry point widens them on load, the twin on
read), counting each in a plain integer on the function
(`tri_energy_grad.launches`, of them `.launches_bf16` on bf16 tiles,
`tri_energy_grad_plain.calls`).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import List, Optional, Tuple

import torch

from chromosome3d_tpu_torch.ops import _build
from chromosome3d_tpu_torch.ops.energy import EnergyWeights
from chromosome3d_tpu_torch.ops.fused_step import fused_step_feasible, fused_steps_plan
from chromosome3d_tpu_torch.ops.pair_energy import (
    TILE_DTYPES,
    check_inputs,
    exact_rows_plain,
    tile_dtype,
)
from chromosome3d_tpu_torch.utils import trace

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


def _dispatch_source():
    """The one table file the reader reads and `calibrate` writes, as (name,
    path): ("env", CHROM3D_DISPATCH_TABLE) when it is set, else ("user",
    the port's user cache)."""
    p = os.environ.get("CHROM3D_DISPATCH_TABLE", "").strip()
    return ("env", p) if p else (
        "user", os.path.expanduser("~/.cache/chromosome3d_torch/dispatch.json"))


_DISPATCH_CACHE: dict = {}


def _load_dispatch_file(path: str):
    """One table file, memoized per (path, mtime); None when absent or not
    JSON."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    key = (path, mtime)
    if key not in _DISPATCH_CACHE:
        for k in [k for k in _DISPATCH_CACHE if k[0] == path]:
            del _DISPATCH_CACHE[k]
        try:
            with open(path) as f:
                _DISPATCH_CACHE[key] = json.load(f)
        except (OSError, ValueError):
            return None
    return _DISPATCH_CACHE.get(key)


def _active_dispatch(kind: str):
    """(entries, source name) for a device kind: the table's entries for it,
    or ([], "none") (the frozen defaults then decide)."""
    name, path = _dispatch_source()
    entries = ((_load_dispatch_file(path) or {}).get(kind) or {}).get("entries", [])
    return (entries, name) if entries else ([], "none")


def dispatch_table_fingerprint() -> str:
    """A short hash of the table file that can steer routing, "none" where
    there is none. Provenance for describe_dispatch only: the port compiles
    no program that depends on the table."""
    name, path = _dispatch_source()
    if not os.path.exists(path):
        return "none"
    with open(path, "rb") as f:
        return f"{name}:{hashlib.sha256(f.read()).hexdigest()[:12]}"


def _device_kind(device=None) -> str:
    """The key of a device's entries: torch.cuda.get_device_name on a CUDA
    device, "cpu" on the CPU. device None is the device the port's entry
    points take by default: the current CUDA device, the CPU without one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _select_dispatch_entry(entries, L: int, batch):
    """The nearest measured entry: |log(L / entry L)| first, ties broken by
    |log(batch / entry B)| where the caller gives its batch (an entry with
    no B was measured at 4). None where the nearest is more than 2x away in
    L: a sparse table does not steer shapes it never measured."""
    def ld(e):
        return abs(math.log(max(L, 1) / max(e["L"], 1)))

    best = min(ld(e) for e in entries)
    if best > math.log(2.0) + 1e-9:
        return None
    near = [e for e in entries if ld(e) <= best + 1e-9]
    if batch is not None and len(near) > 1:
        near = sorted(near, key=lambda e: abs(math.log(max(batch, 1) / max(e.get("B", 4), 1))))
    return near[0]


def _entry_seconds(entry, key: str) -> float:
    """A variant's seconds in an entry; null or missing (infeasible) is
    infinity. Legacy files with the Infinity token load through json too."""
    v = entry.get(key)
    return float("inf") if v is None else float(v)


def use_triangular(L: int, for_unfused: bool = False, batch: Optional[int] = None,
                   device=None) -> bool:
    """Whether the triangular kernel B3 runs at L: the JAX package's
    `use_triangular` (pallas_energy.py:1233-1294). B3 needs at least 3 of
    its tiles. Then the measured table decides where it has an entry within
    2x of L (`_select_dispatch_entry`, batch the caller's structures a
    chromosome), with 3% hysteresis: for the pick and the other unfused
    callers (for_unfused) tri_unfused against row_unfused; on the annealing
    step B3 wherever the fused step B1 cannot run, else semi against fused,
    an entry silent on fused keeping the frozen default. With no entry the
    frozen defaults: from L = 1024 for the unfused callers, only past the
    fused step's reach on the step. CHROM3D_NO_TRI set: never. device: whose
    entries (`_device_kind`). Tests replace this function to force a route,
    as the JAX tests replace theirs."""
    if os.environ.get("CHROM3D_NO_TRI"):
        return False
    if -(-max(L, 8) // TILE) < 3:
        return False
    entries, _ = _active_dispatch(_device_kind(device))
    best = _select_dispatch_entry(entries, L, batch) if entries else None
    if best is not None:
        if for_unfused:
            return (_entry_seconds(best, "tri_unfused_s")
                    < 0.97 * _entry_seconds(best, "row_unfused_s"))
        if not fused_step_feasible(L):
            return True
        fused_s = _entry_seconds(best, "fused_s")
        if math.isinf(fused_s):
            return False
        return _entry_seconds(best, "semi_s") < 0.97 * fused_s
    if for_unfused:
        return L >= 1024
    return not fused_step_feasible(L)


def describe_dispatch(L: int, batch: Optional[int] = None, exact: bool = True,
                      fusable: bool = True, or_groups: bool = False, device=None) -> dict:
    """Which step route a solve at (L, batch) takes and what decided it: the
    JAX package's `describe_dispatch`, with the same keys. route: "fused"
    (B1), "semi" (B3 + B4), "semi_general" (B5 + B4), "unfused_tri" or
    "unfused_row" (B3 or B2 + the unfused step); it mirrors
    solver.anneal's route choice (`step_route`). tile_tri and tile_fused
    are the port's: B3's tile and B1's row group (None where B1 cannot
    run); table_fingerprint is provenance only."""
    ff = fused_step_feasible(L)
    kind = _device_kind(device)
    entries, source = _active_dispatch(kind)
    entry = _select_dispatch_entry(entries, L, batch) if entries else None
    if not fusable:
        route = ("unfused_tri" if use_triangular(L, True, batch, device) else "unfused_row")
    elif exact:
        if not or_groups and ff and not use_triangular(L, False, batch, device):
            route = "fused"
        elif os.environ.get("CHROM3D_NO_TRI"):
            route = "unfused_row"
        else:
            route = "semi"
    else:
        route = "semi_general"
    return {
        "route": route,
        "L": int(L),
        "batch": None if batch is None else int(batch),
        "fused_feasible": bool(ff),
        "tile_tri": TILE,
        "tile_fused": fused_steps_plan(L, batch or 1)["rows"] if ff else None,
        "device_kind": kind,
        "table_source": source,
        "table_entry": None if entry is None else {
            k: entry.get(k) for k in ("L", "B", "fused_s", "semi_s", "tri_unfused_s",
                                      "row_unfused_s")},
        "table_fingerprint": dispatch_table_fingerprint(),
    }


def _tri_plain_one(xT, target, w, weights, bead_mask):
    """B3's twin for one chromosome: B2's plain math (`exact_rows_plain`)
    over the whole pair matrix, in row chunks so the temporaries stay near
    64 MiB each at the at-scale shape."""
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


def tri_energy_grad_plain(
    xT: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B3. Returns (pair energies (B,), gradients (B, 3, L)).
    With (C, L, L) tiles and (C, L) bead masks each chromosome's B / C
    structures are evaluated alone, in chromosome order."""
    tri_energy_grad_plain.calls += 1
    if target.dim() == 2:
        return _tri_plain_one(xT, target, w, weights, bead_mask)
    n = xT.shape[0] // target.shape[0]
    outs = [_tri_plain_one(xT[c * n:(c + 1) * n], target[c], w[c], weights, bead_mask[c])
            for c in range(target.shape[0])]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


tri_energy_grad_plain.calls = 0


def tri_energy_grad(
    xT: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3 for a batch sharing one restraint set: xT (B, 3, L), target and
    folded weight w (L, L), symmetric (as every restraint set of both
    packages is: the kernel takes each unordered pair's target and weight
    from its row tile), bead_mask (L,), all float32 and contiguous (target
    and w may both be bfloat16: pair_bf16); or for C
    chromosomes of B / C structures each, chromosome-major, with target and
    w (C, L, L) and bead_mask (C, L) — a genome bucket in one launch, each
    chromosome's outputs bitwise those of a launch of its own. Returns (pair
    energies (B,), pair gradients (B, 3, L)). CPU tensors run the plain
    twin; CUDA tensors launch csrc/exact_tri.cu, whose row and column
    partials land in a (B, 2S, 3, T * TILE) scratch buffer that a second
    kernel sums per bead in a fixed order (no atomics: equal inputs give
    equal bits)."""
    if xT.dim() != 3:
        raise ValueError(f"xT must be (B, 3, L), got {tuple(xT.shape)}")
    B, L = xT.shape[0], xT.shape[2]
    lead = () if target.dim() == 2 else (target.shape[0],)
    C = lead[0] if lead else 1
    if C == 0 or B % C:
        raise ValueError(f"{B} structures do not divide over {C} chromosomes")
    dev = check_inputs({
        "xT": (xT, (B, 3, L)), "target": (target, (*lead, L, L), TILE_DTYPES),
        "w": (w, (*lead, L, L), TILE_DTYPES), "bead_mask": (bead_mask, (*lead, L)),
    })
    kind = tile_dtype(target, w)
    if B == 0 or L == 0:
        raise ValueError(f"empty batch: B={B}, L={L}")
    if dev.type == "cpu":
        return tri_energy_grad_plain(xT, target, w, weights, bead_mask)
    n = B // C
    plan = tri_plan(n, L, L, TILE)
    lib = _build.load_library()
    part = torch.empty((B, *plan["part_shape"][1:]), dtype=torch.float32, device=dev)
    e_part = torch.empty((B, plan["e_part_shape"][1]), dtype=torch.float32, device=dev)
    gT = torch.empty_like(xT)
    e = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.entry(lib, "c3d_exact_tri", kind)(
            xT.data_ptr(), target.data_ptr(), w.data_ptr(), bead_mask.data_ptr(),
            part.data_ptr(), e_part.data_ptr(), gT.data_ptr(), e.data_ptr(),
            C, n, L, plan["Tg"], TILE, plan["bslice"], weights.noe, weights.vdw,
            weights.vdw_radius,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "c3d_exact_tri")
    tri_energy_grad.launches += 1
    tri_energy_grad.launches_bf16 += kind == torch.bfloat16
    return e, gT


trace.count_launches(tri_energy_grad)
tri_energy_grad.launches_bf16 = 0   # of them, on bf16 tiles
