"""Kernel B1: one whole annealing step (csrc/fused_step.cu) and its plain
PyTorch twin.

Replaces chromosome3d_tpu/ops/pallas_energy.py `_kernel_fused_step` (entry
`pallas_fused_step_batched`, tiles from `fused_step_tiles`, helpers
`_t_layout_bond` and `_t_layout_noise`). Same contract and the same
(B, 3, L) state layout at the public face: pair energy and gradient in the
exact-restraint rsqrt-space algebra, chain bond, per-bead clip, Adam with
the bias corrections passed in, CLT-4 murmur3 Langevin noise (bitwise the
JAX package's) and x' = x + (-lr * upd + sigma * noise) * bead.

Unlike the Pallas entry, nothing is padded to a 128-multiple: the kernel
masks the ragged edge itself. Padded beads (bead_mask 0) with zero state
stay exactly zero in x, mu and nu.

`fused_step_batched` runs the plain twin for CPU tensors and the CUDA kernel
for CUDA tensors, counting each in a plain integer on the function
(`fused_step_batched.launches`, `fused_step_plain.calls`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from chromosome3d_tpu_torch.ops import _build
from chromosome3d_tpu_torch.ops.energy import _EPS, EnergyWeights, f32
from chromosome3d_tpu_torch.ops.pair_energy import check_inputs, exact_pair_tiles

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
    """The step's static (L, L) tiles, built once per solve: restraint
    target, weights pre-scaled by 2 * noe and pre-masked by bead validity,
    and the pre-masked vdw predicate (|i - j| >= 2 and both beads real)."""
    tgt, w_folded = exact_pair_tiles(restraints)
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
    pair gradient summed as sum_j c_ij (x_i - x_j), like the kernel)."""
    fused_step_plain.calls += 1
    t, w, nb = tiles
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


def fused_step_batched(
    xT: torch.Tensor, muT: torch.Tensor, nuT: torch.Tensor, tiles,
    weights: EnergyWeights, bead_mask: torch.Tensor,
    lr, sigma, bc1, bc2, seed: int, step: int, clip: Optional[float],
    b1: float = 0.9, b2: float = 0.999, eps_adam: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One annealing step for a shared-restraint batch -> (energies (B,),
    xT', muT', nuT'), state (B, 3, L) float32. tiles = fused_step_tiles(...);
    clip None or <= 0 disables the clip. CPU tensors run the plain twin;
    CUDA tensors launch csrc/fused_step.cu into freshly allocated outputs
    (the kernel reads the whole old x, so it never writes in place)."""
    if xT.dim() != 3:
        raise ValueError(f"xT must be (B, 3, L), got {tuple(xT.shape)}")
    B, L = xT.shape[0], xT.shape[2]
    t, w, nb = tiles
    dev = check_inputs({
        "xT": (xT, (B, 3, L)), "muT": (muT, (B, 3, L)), "nuT": (nuT, (B, 3, L)),
        "t": (t, (L, L)), "w": (w, (L, L)), "nb": (nb, (L, L)),
        "bead_mask": (bead_mask, (L,)),
    })
    if B == 0 or L == 0:
        raise ValueError(f"empty batch: B={B}, L={L}")
    if dev.type == "cpu":
        return fused_step_plain(xT, muT, nuT, tiles, weights, bead_mask, lr,
                                sigma, bc1, bc2, seed, step, clip, b1, b2,
                                eps_adam)
    lib = _build.load_library()
    e_rows = torch.empty((B, L), dtype=torch.float32, device=dev)
    x_new, mu_new, nu_new = (torch.empty_like(xT) for _ in range(3))
    with torch.cuda.device(dev):
        err = lib.c3d_fused_step(
            xT.data_ptr(), muT.data_ptr(), nuT.data_ptr(), t.data_ptr(),
            w.data_ptr(), nb.data_ptr(), bead_mask.data_ptr(),
            e_rows.data_ptr(), x_new.data_ptr(), mu_new.data_ptr(),
            nu_new.data_ptr(), B, L,
            weights.vdw, weights.vdw_radius, lr, sigma, b1, b2, eps_adam,
            bc1, bc2, weights.bond, weights.bond_length,
            -1.0 if clip is None else clip,
            _c_int32(seed), _c_int32(step),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "c3d_fused_step")
    fused_step_batched.launches += 1
    return e_rows.sum(1), x_new, mu_new, nu_new


fused_step_batched.launches = 0
