"""The plain row-block energy of one shard — the port of
chromosome3d_tpu/parallel/sharded_energy.py `_row_block_energy_grad`.

The JAX package writes it in jnp (no Pallas kernel): the sharded solver
evaluates the final canonical-weight energy terms through it on every
shard, and the shards' partials are summed. Plain PyTorch here, batched
over the structures, in column slabs of at most 4096 so the temporaries
stay (B, Lb, Lc) and no (B, Lb, L, 3) difference tensor exists.
"""

from __future__ import annotations

from typing import Tuple

import torch

from chromosome3d_tpu_torch.ops.energy import _EPS, EnergyWeights

_COL_CHUNK = 4096


def _pick_col_chunk(L: int) -> int:
    """Largest divisor of L that is <= _COL_CHUNK (full width if none)."""
    if L <= _COL_CHUNK:
        return L
    for c in range(_COL_CHUNK, 127, -1):
        if L % c == 0:
            return c
    return L


def row_block_energy_grad(
    x: torch.Tensor,          # (B, L, 3) every structure, replicated
    lo: torch.Tensor,         # (Lb, L) this shard's rows
    hi: torch.Tensor,
    w: torch.Tensor,          # mask-folded weights rows
    bead_mask: torch.Tensor,  # (L,)
    row_start: int,           # global index of the strip's first row
    weights: EnergyWeights,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(NOE energy partials (B,), vdw energy partials (B,), gradient rows
    (B, Lb, 3)) of one row strip: the pair terms of rows [row_start,
    row_start + Lb) against every column, d = sqrt(s2), c / d, the
    soft-square well on [lo, hi] and the vdw repel with the global
    |i - j| >= 2 predicate; strips stored bf16 are widened a slab at a
    time. Bond terms are the caller's."""
    B, L, _ = x.shape
    Lb = lo.shape[0]
    a = x[:, row_start:row_start + Lb]
    bm_rows = bead_mask[row_start:row_start + Lb]
    Lc = _pick_col_chunk(L)
    s = weights.noe_rswitch
    dev, dt = x.device, x.dtype
    e_noe = torch.zeros(B, dtype=dt, device=dev)
    e_vdw = torch.zeros(B, dtype=dt, device=dev)
    crow = torch.zeros((B, Lb), dtype=dt, device=dev)
    cx = torch.zeros((B, Lb, 3), dtype=dt, device=dev)
    rows = row_start + torch.arange(Lb, device=dev)
    for c0 in range(0, L, Lc):
        xk = x[:, c0:c0 + Lc]
        bmk = bead_mask[c0:c0 + Lc]
        lok, hik, wk = (a[:, c0:c0 + Lc].float() for a in (lo, hi, w))
        s2 = torch.full((B, Lb, xk.shape[1]), _EPS, dtype=dt, device=dev)
        for ax in range(3):
            dc = a[:, :, ax, None] - xk[:, None, :, ax]
            s2 = s2 + dc * dc
        d = torch.sqrt(s2)
        pair_valid = bm_rows[:, None] * bmk[None, :]

        over = torch.clamp_min(d - hik, 0.0)
        under = torch.clamp_min(lok - d, 0.0)
        viol = over + under
        quad = viol <= s
        well = torch.where(quad, viol * viol, s * s + 2.0 * s * (viol - s))
        wm = wk * pair_valid
        e_noe = e_noe + 0.5 * weights.noe * (wm * well).sum((1, 2))
        dwell = torch.where(quad, 2.0 * viol, torch.full_like(viol, 2.0 * s))
        sgn = torch.where(over > 0.0, 1.0, torch.where(under > 0.0, -1.0, 0.0))
        c_noe = weights.noe * wm * dwell * sgn

        cols = c0 + torch.arange(xk.shape[1], device=dev)
        nonbonded = ((rows[:, None] - cols[None, :]).abs() >= 2).to(dt) * pair_valid
        overlap = torch.clamp_min(weights.vdw_radius - d, 0.0)
        e_vdw = e_vdw + 0.5 * weights.vdw * (nonbonded * overlap * overlap).sum((1, 2))
        c_vdw = -2.0 * weights.vdw * nonbonded * overlap

        c = (c_noe + c_vdw) / d
        crow = crow + c.sum(-1)
        cx = cx + c @ xk
    return e_noe, e_vdw, a * crow[..., None] - cx
