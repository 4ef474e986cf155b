"""Kernel B5: general-restraint pair energy + gradient (csrc/general_pair.cu)
and its plain PyTorch twin.

Replaces chromosome3d_tpu/ops/pallas_energy.py `_kernel` (entry
`_pairwise_energy_grad_batched(..., exact=False)`): the soft-square
flat-bottom well on [lo, hi] with linear tails past noe_rswitch, plus the
vdw repel, the 1/2 ordered-pair energy convention. It reads and writes the
(B, 3, L) layout kernel B4 consumes, so the semi-general step pays no
transposes; the tiles (lo, hi, w = mask * weight) are folded once per solve
(`general_pair_tiles`).

`general_pair_energy_grad` runs the plain twin for CPU tensors and the CUDA
kernel for CUDA tensors, counting each in a plain integer on the function
(`general_pair_energy_grad.launches`, `general_pair_energy_grad_plain.calls`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from chromosome3d_tpu_torch.ops import _build
from chromosome3d_tpu_torch.ops.energy import _EPS, EnergyWeights
from chromosome3d_tpu_torch.ops.pair_energy import check_inputs

_PLAIN_CHUNK_ELEMS = 1 << 24    # the twin's (B, rows, L) temporaries per chunk


def general_pair_tiles(restraints):
    """(lo, hi, w = mask * weight) as contiguous tensors: the fold the
    kernel reads, made once per solve."""
    return (restraints.lo.contiguous(), restraints.hi.contiguous(),
            (restraints.mask * restraints.weight).contiguous())


def general_rows_plain(
    coords: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor, r0: int, r1: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `_kernel` math for rows [r0, r1) of the pair matrix of (B, L, 3)
    coords: returns (the rows' pair energies summed (B,), their gradients
    (B, r1 - r0, 3)). The gradient is summed as sum_j c_ij (x_i - x_j), like
    the kernel (see general_pair.cu)."""
    x = coords
    L = x.shape[1]
    diffs = [x[:, r0:r1, c, None] - x[:, None, :, c] for c in range(3)]
    d2 = torch.zeros(x.shape[0], r1 - r0, L, dtype=x.dtype, device=x.device)
    for diff in diffs:
        d2 = d2 + diff * diff
    rinv = torch.rsqrt(d2 + _EPS)
    d = (d2 + _EPS) * rinv
    pair_valid = bead_mask[r0:r1, None] * bead_mask[None, :]
    wv = w[r0:r1] * pair_valid
    over = torch.clamp_min(d - hi[r0:r1], 0.0)
    under = torch.clamp_min(lo[r0:r1] - d, 0.0)
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


def general_pair_energy_grad_plain(
    xT: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B5: the `_kernel` math over the whole pair matrix, in
    row chunks so the temporaries stay near 64 MiB each at L = 5120.
    Returns (pair energies (B,), gradients (B, 3, L))."""
    general_pair_energy_grad_plain.calls += 1
    B, _, L = xT.shape
    coords = xT.transpose(1, 2)
    rows = max(1, _PLAIN_CHUNK_ELEMS // (B * L))
    e = torch.zeros(B, dtype=xT.dtype, device=xT.device)
    gT = torch.empty_like(xT)
    for r0 in range(0, L, rows):
        r1 = min(r0 + rows, L)
        e_c, g_c = general_rows_plain(coords, lo, hi, w, weights, bead_mask, r0, r1)
        e = e + e_c
        gT[:, :, r0:r1] = g_c.transpose(1, 2)
    return e, gT


general_pair_energy_grad_plain.calls = 0


def general_pair_energy_grad(
    xT: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5 for a batch sharing one restraint set: xT (B, 3, L), the tiles lo,
    hi and folded weight w (L, L), bead_mask (L,), all float32 and
    contiguous. Returns (pair energies (B,), pair gradients (B, 3, L)). CPU
    tensors run the plain twin; CUDA tensors launch csrc/general_pair.cu,
    which writes per-row energies that one torch sum adds (no atomics:
    equal inputs give equal bits)."""
    if xT.dim() != 3:
        raise ValueError(f"xT must be (B, 3, L), got {tuple(xT.shape)}")
    B, L = xT.shape[0], xT.shape[2]
    dev = check_inputs({
        "xT": (xT, (B, 3, L)), "lo": (lo, (L, L)), "hi": (hi, (L, L)),
        "w": (w, (L, L)), "bead_mask": (bead_mask, (L,)),
    })
    if B == 0 or L == 0:
        raise ValueError(f"empty batch: B={B}, L={L}")
    if dev.type == "cpu":
        return general_pair_energy_grad_plain(xT, lo, hi, w, weights, bead_mask)
    lib = _build.load_library()
    e_rows = torch.empty((B, L), dtype=torch.float32, device=dev)
    gT = torch.empty_like(xT)
    with torch.cuda.device(dev):
        err = lib.c3d_general_pair(
            xT.data_ptr(), lo.data_ptr(), hi.data_ptr(), w.data_ptr(),
            bead_mask.data_ptr(), e_rows.data_ptr(), gT.data_ptr(), B, L,
            weights.noe, weights.vdw, weights.vdw_radius, weights.noe_rswitch,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "c3d_general_pair")
    general_pair_energy_grad.launches += 1
    return e_rows.sum(1), gT


general_pair_energy_grad.launches = 0
