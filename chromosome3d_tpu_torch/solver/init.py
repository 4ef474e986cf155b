"""Starting coordinates — the port of chromosome3d_tpu/solver/init.py's
reference-scale part: classical MDS of the shortest-path-completed bounds
(`mds_init`), plus the spiral and random starts.

mmdg's metric-matrix embedding is classical MDS: smooth the restraint bounds
with all-pairs shortest paths (min-plus squarings), double-centre the
squared distances and embed on the top-3 eigenpairs (subspace iteration and
a 3 x 3 Rayleigh-Ritz). Plain PyTorch on the solve's device; matrix
products run in full float32 (the package disables TF32, device.py). The
landmark init and the two-sided bounds smoothing are not ported yet
(ROADMAP A9, A10).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

_BIG = 1e6


def _minplus_square(a: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """One min-plus squaring out[i, j] = min_k a[i, k] + a[k, j], blocked
    over k so the peak temporary is L * chunk * L."""
    L = a.shape[0]
    out = a
    for k0 in range(0, L, chunk):
        cols = a[:, k0:k0 + chunk]                   # (L, c)
        rows = a[k0:k0 + chunk, :]                   # (c, L)
        cand = (cols[:, :, None] + rows[None, :, :]).amin(dim=1)
        out = torch.minimum(out, cand)
    return out


def smooth_bounds(
    restraints, bond_length: float, n_iters: Optional[int] = None,
    unknown_fill: str = "shortest_path", bead_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The (L, L) completed upper-bound distance matrix for the MDS embed:
    restraint targets where restraints exist, bond_length between
    consecutive real beads, unrestrained pairs completed by shortest paths
    ("shortest_path") or the largest restraint target ("max_target").
    Padding beads get no chain bonds and stay at _BIG."""
    L = restraints.lo.shape[0]
    dev = restraints.lo.device
    target = 0.5 * (restraints.lo + restraints.hi)
    mask = restraints.mask > 0
    w = torch.where(mask, target, torch.full_like(target, _BIG))
    idx = torch.arange(L, device=dev)
    adjacent = (idx[:, None] - idx[None, :]).abs() == 1
    eye = idx[:, None] == idx[None, :]
    if bead_mask is not None:
        pair_real = (bead_mask[:, None] * bead_mask[None, :]) > 0
        adjacent = adjacent & pair_real
    w = torch.where(adjacent, torch.clamp_max(w, bond_length), w)
    w = torch.where(eye, torch.zeros_like(w), w)
    if unknown_fill == "max_target":
        fill = torch.where(mask, target, torch.zeros_like(target)).max()
        filled = torch.minimum(w, torch.clamp_min(fill, bond_length))
        if bead_mask is not None:
            filled = torch.where(pair_real | eye, filled, w)
        return filled
    if unknown_fill != "shortest_path":
        raise ValueError(f"unknown mds_unknown_fill {unknown_fill!r}")
    if n_iters is None:
        n_iters = max(1, int(np.ceil(np.log2(max(L, 2)))))
    for _ in range(n_iters):
        w = _minplus_square(w)
    return w


def _orthonormalize(v: torch.Tensor) -> torch.Tensor:
    """Modified Gram-Schmidt on the 3 columns of (L, 3)."""
    q0 = v[:, 0] / (torch.linalg.norm(v[:, 0]) + 1e-12)
    v1 = v[:, 1] - (q0 @ v[:, 1]) * q0
    q1 = v1 / (torch.linalg.norm(v1) + 1e-12)
    v2 = v[:, 2] - (q0 @ v[:, 2]) * q0 - (q1 @ v[:, 2]) * q1
    q2 = v2 / (torch.linalg.norm(v2) + 1e-12)
    return torch.stack([q0, q1, q2], dim=1)


def _top3_eig(b: torch.Tensor, iters: int = 60):
    """Top-3 eigenpairs of a symmetric matrix by subspace iteration from a
    DCT start, then Rayleigh-Ritz on the 3-dim subspace. Returns
    (values (3,), vectors (L, 3)), descending."""
    L = b.shape[0]
    t = torch.arange(L, dtype=torch.float32, device=b.device)
    v = torch.stack([
        torch.ones(L, dtype=torch.float32, device=b.device),
        torch.cos(math.pi * (t + 0.5) / L),
        torch.cos(2.0 * math.pi * (t + 0.5) / L),
    ], dim=1)
    v = _orthonormalize(v)
    for _ in range(iters):
        v = _orthonormalize(b @ v)
    small = v.T @ (b @ v)                            # (3, 3) symmetric
    # a 3 x 3 eigh: on the host, where it costs nothing
    w, s = torch.linalg.eigh(small.cpu())
    v = v @ s.to(b.device)
    return w.flip(0).to(b.device), v.flip(1)


def mds_init(
    restraints, bond_length: float = 3.8, unknown_fill: str = "shortest_path",
    bead_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Classical MDS embedding of the smoothed bounds -> (L, 3) float32 on
    the restraints' device. bead_mask restricts the double-centring to real
    beads; padding rows come out zero. Chirality is arbitrary, which is why
    the annealer keeps the enantiomer trial."""
    d = smooth_bounds(restraints, bond_length, unknown_fill=unknown_fill,
                      bead_mask=bead_mask)
    L = d.shape[0]
    d2 = d * d
    if bead_mask is None:
        j = torch.eye(L, dtype=d2.dtype, device=d2.device) - 1.0 / L
        b = -0.5 * (j @ d2 @ j)
    else:
        m = bead_mask.to(d2.dtype)
        n = torch.clamp_min(m.sum(), 1.0)
        mu_i = (d2 * m[None, :]).sum(1) / n           # masked row means
        mu = (m * mu_i).sum() / n                     # masked grand mean
        pair = m[:, None] * m[None, :]
        b = -0.5 * (d2 - mu_i[:, None] - mu_i[None, :] + mu) * pair
    top_vals, top_vecs = _top3_eig(b)
    top_vals = torch.clamp_min(top_vals, 0.0)
    return (top_vecs * torch.sqrt(top_vals)[None, :]).to(torch.float32)


def random_init(generator: torch.Generator, L: int, scale: float = 30.0,
                device="cpu") -> torch.Tensor:
    """Uniform random cloud in [-scale, scale)^3, drawn from `generator`
    (a CPU generator, so a seed gives the same start on every device)."""
    u = torch.rand((L, 3), generator=generator, dtype=torch.float32)
    return (scale * (2.0 * u - 1.0)).to(device)


def spiral_init(L: int, bond_length: float = 3.8, turns_per_bead: float = 0.2,
                device="cpu") -> torch.Tensor:
    """Deterministic helix: a self-avoiding chain with correct bond lengths."""
    t = torch.arange(L, dtype=torch.float32, device=device)
    theta = 2.0 * math.pi * turns_per_bead * t
    radius = bond_length / (2.0 * math.sin(math.pi * turns_per_bead) + 1e-6) * 0.9
    pitch = bond_length * 0.4
    return torch.stack(
        [radius * torch.cos(theta), radius * torch.sin(theta), pitch * t], dim=-1
    )
