"""Starting coordinates — the port of chromosome3d_tpu/solver/init.py:
classical MDS of the shortest-path-completed bounds (`mds_init`), landmark
MDS for L >= 2048 (`landmark_init`), both one-sided or two-sided, plus the
spiral and random starts.

mmdg's metric-matrix embedding is classical MDS: smooth the restraint bounds
with all-pairs shortest paths (min-plus squarings), double-centre the
squared distances and embed on the top-3 eigenpairs (subspace iteration and
a 3 x 3 Rayleigh-Ritz). Landmark MDS needs only the k x L landmark-to-all
distances (Bellman-Ford sweeps over row strips of the edge matrix) and
triangulates the rest with one (L, k) @ (k, 3) product. Plain PyTorch on
the solve's device; matrix products run in full float32 (the package
disables TF32, device.py). Restraint files with real deviation windows
(lo < hi) embed two-sided (`two_sided=True`, AnnealConfig.embed_two_sided):
upper bounds relax by shortest paths through hi, lower bounds rise by the
inverse triangle inequality, and restrained pairs embed at the midpoint of
their smoothed window (mmdg's bounds-matrix smoothing).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from chromosome3d_tpu_torch.ops.energy import ExactRestraints
from chromosome3d_tpu_torch.utils import trace

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


def _maxminus_sweep(lo: torch.Tensor, up: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """One inverse-triangle sweep out[i, j] = max(lo[i, j], max_k lo[i, k] -
    up[k, j]): the lower-bound propagation of bounds-matrix smoothing,
    blocked over k like _minplus_square."""
    L = lo.shape[0]
    out = lo
    for k0 in range(0, L, chunk):
        cand = (lo[:, k0:k0 + chunk, None] - up[None, k0:k0 + chunk, :]).amax(dim=1)
        out = torch.maximum(out, cand)
    return out


def smooth_bounds_two_sided(
    restraints, bond_length: float, n_iters: Optional[int] = None,
    lower_iters: int = 2, bead_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bounds-matrix smoothing for restraints with deviation windows: upper
    bounds hi tightened by all-pairs shortest paths, lower bounds lo raised
    by lo_ij >= max_k max(lo_ik - hi_kj, lo_kj - hi_ik); restrained pairs
    then embed at the window midpoint clipped into [lo, hi], unrestrained
    ones at the shortest-path upper. Equal to smooth_bounds when lo == hi
    everywhere. Returns the (L, L) embed target matrix."""
    L = restraints.lo.shape[0]
    dev = restraints.lo.device
    idx = torch.arange(L, device=dev)
    eye = idx[:, None] == idx[None, :]
    adjacent = (idx[:, None] - idx[None, :]).abs() == 1
    if bead_mask is not None:
        adjacent = adjacent & ((bead_mask[:, None] * bead_mask[None, :]) > 0)
    mask = restraints.mask > 0
    zeros = torch.zeros_like(restraints.lo)

    up = torch.where(mask, restraints.hi, torch.full_like(restraints.hi, _BIG))
    up = torch.where(adjacent, torch.clamp_max(up, bond_length), up)
    up = torch.where(eye, zeros, up)
    if n_iters is None:
        n_iters = max(1, int(np.ceil(np.log2(max(L, 2)))))
    for _ in range(n_iters):
        up = _minplus_square(up)

    lo = torch.where(mask & ~eye, restraints.lo, zeros)
    for _ in range(lower_iters):
        cand = _maxminus_sweep(lo, up)
        lo = torch.where(eye, zeros, torch.maximum(lo, torch.maximum(cand, cand.T)))
    lo = torch.minimum(lo, up)   # a contradictory pair collapses to its upper
    mid = torch.minimum(torch.maximum(0.5 * (lo + up), lo), up)
    return torch.where(mask, mid, up)


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
    w, s = torch.linalg.eigh(trace.to_host(small))
    v = v @ trace.to_device(s, b.device)
    return trace.to_device(w.flip(0), b.device), v.flip(1)


def mds_init(
    restraints, bond_length: float = 3.8, unknown_fill: str = "shortest_path",
    bead_mask: Optional[torch.Tensor] = None, two_sided: bool = False,
) -> torch.Tensor:
    """Classical MDS embedding of the smoothed bounds -> (L, 3) float32 on
    the restraints' device. bead_mask restricts the double-centring to real
    beads; padding rows come out zero. two_sided: the bounds-matrix
    smoothing (smooth_bounds_two_sided) instead of the one-sided one.
    Chirality is arbitrary, which is why the annealer keeps the enantiomer
    trial."""
    if two_sided:
        d = smooth_bounds_two_sided(restraints, bond_length, bead_mask=bead_mask)
    else:
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


# ---------------------------------------------------------------------------
# Landmark MDS: the at-scale init (O(k L^2) work, O(k L) extra memory)
# ---------------------------------------------------------------------------


def landmark_indices(L: int, k: int, n_real, device="cpu") -> torch.Tensor:
    """k evenly spaced real bead indices (n_real: a count or a 0-d float32
    tensor); float32 arithmetic and truncation, as the JAX package's."""
    frac = torch.arange(k, dtype=torch.float32, device=device) / max(k - 1, 1)
    return torch.clamp((frac * (n_real - 1)).to(torch.int64), 0, L - 1)


def chain_metric_rows(lidx: torch.Tensor, L: int, bond_length: float) -> torch.Tensor:
    """Chain-walk upper bound |l - j| * bond_length for the landmark rows —
    an exact upper bound on the graph distance, so relaxation only ever
    tightens it."""
    j = torch.arange(L, dtype=torch.float32, device=lidx.device)
    return (lidx[:, None].to(torch.float32) - j[None, :]).abs() * bond_length


def relax_landmarks_block(delta: torch.Tensor, w_block: torch.Tensor,
                          row_start: int, chunk: int = 8) -> torch.Tensor:
    """One Bellman-Ford sweep restricted to one row strip:
    cand[l, j] = min over the strip's rows m of delta[l, m] + w[m, j].
    Returns (k, L); the caller min-reduces over strips. Chunked over
    landmarks to bound the (chunk, Lb, L) temporary."""
    Lb = w_block.shape[0]
    d_cols = delta[:, row_start:row_start + Lb]                 # (k, Lb)
    return torch.cat([
        (d_cols[c0:c0 + chunk, :, None] + w_block[None]).amin(dim=1)
        for c0 in range(0, delta.shape[0], chunk)
    ])


def relax_landmarks_lower_block(delta: torch.Tensor, lo_block: torch.Tensor,
                                row_start: int, chunk: int = 8) -> torch.Tensor:
    """One inverse-triangle lower-bound sweep on the landmark rows,
    restricted to one row strip: cand[l, j] = max over the strip's rows m
    of lo[m, j] - delta[l, m] (d_lj >= d_mj - d_lm >= lo_mj - up_lm).
    Returns (k, L); the caller max-reduces over strips."""
    Lb = lo_block.shape[0]
    d_cols = delta[:, row_start:row_start + Lb]                 # (k, Lb)
    return torch.cat([
        (lo_block[None] - d_cols[c0:c0 + chunk, :, None]).amax(dim=1)
        for c0 in range(0, delta.shape[0], chunk)
    ])


def clip_landmark_targets(delta: torch.Tensor, lo_land: torch.Tensor,
                          mask_land: torch.Tensor) -> torch.Tensor:
    """Two-sided embed targets for the landmark rows: restrained pairs at
    the midpoint of their smoothed [lo, up] window, unrestrained ones at the
    shortest-path upper (smooth_bounds_two_sided's rule on k rows)."""
    lo_land = torch.minimum(lo_land, delta)    # contradictions collapse upward
    mid = torch.minimum(torch.maximum(0.5 * (lo_land + delta), lo_land), delta)
    return torch.where(mask_land > 0, mid, delta)


def landmark_triangulate(delta: torch.Tensor, lidx: torch.Tensor) -> torch.Tensor:
    """Landmark-MDS triangulation: classical MDS on the k x k landmark
    submatrix, then every bead embeds as
        x_j = -1/2 diag(1/sqrt(lambda)) V^T (delta_j^2 - rowmean(Dk^2)).
    Degenerate eigendirections are dropped, not divided by (the JAX
    package's rule: 1/sqrt(lambda ~ 0) would amplify eigenvector noise).
    Returns (L, 3)."""
    k = delta.shape[0]
    dk = delta[:, lidx]                                          # (k, k)
    dk = 0.5 * (dk + dk.T)
    dk2 = dk * dk
    jk = torch.eye(k, dtype=dk2.dtype, device=dk2.device) - 1.0 / k
    b = -0.5 * (jk @ dk2 @ jk)
    lam, v = _top3_eig(b)
    lam = torch.clamp_min(lam, 0.0)
    good = lam > 1e-6 * torch.clamp_min(lam[0], 1e-12)
    inv = torch.where(good, 1.0 / torch.sqrt(torch.clamp_min(lam, 1e-30)),
                      torch.zeros_like(lam))
    mu = dk2.mean(dim=1)                                         # (k,)
    proj = v * inv[None, :]                                      # (k, 3)
    return -0.5 * ((delta * delta - mu[:, None]).T @ proj)       # (L, 3)


def _pick_init_row_block(L: int, cap: int = 4096) -> int:
    """Strip height for the row-blocked relaxation (full L when small). It
    need not divide L: the last strip is clamped to start at L - Lb, and
    min-relaxation is idempotent, so the overlap recomputes identical
    candidates."""
    return min(L, cap)


def _restraint_rows(restraints, r0: int, Lb: int):
    """(lo, hi, mask) float32 row strips sliced from the stored tiles; the
    exact form's mask is built from the sliced w strip only."""
    if isinstance(restraints, ExactRestraints):
        t = restraints.target[r0:r0 + Lb].to(torch.float32)
        return t, t, (restraints.w[r0:r0 + Lb] > 0).to(torch.float32)
    return (
        restraints.lo[r0:r0 + Lb].to(torch.float32),
        restraints.hi[r0:r0 + Lb].to(torch.float32),
        (restraints.mask[r0:r0 + Lb] > 0).to(torch.float32),
    )


def landmark_targets(restraints, bond_length: float = 3.8, k: int = 64,
                     n_iters: int = 4, bead_mask: Optional[torch.Tensor] = None,
                     two_sided: bool = False, lower_iters: int = 1):
    """The (k, L) landmark embed-target rows and the landmark indices. The
    relaxation runs over row strips of at most 4096 rows, each edge strip
    rebuilt from the restraint tiles, so no (L, L) edge matrix is ever held;
    min and max over float32 are exact and order-free, so the result is
    bit-equal to a whole-matrix sweep.

    one-sided: the midpoint-target graph. two_sided: the upper relaxation
    runs through the hi edges (a midpoint path is no upper bound when
    windows are wide), the landmark rows' lower bounds rise by the
    inverse-triangle sweep over the same strips, and restrained pairs embed
    at the midpoint of their smoothed window (clip_landmark_targets)."""
    L = restraints.lo.shape[0]
    dev = restraints.lo.device
    k = min(k, L)
    n_real = bead_mask.sum() if bead_mask is not None else L
    lidx = landmark_indices(L, k, n_real, device=dev)
    Lb = _pick_init_row_block(L)
    cols = torch.arange(L, device=dev)

    def edge_rows(r0: int) -> torch.Tensor:
        """(Lb, L) edge strip: hi (two-sided) or the midpoint target where a
        restraint exists, bond_length between consecutive real beads, _BIG
        otherwise, zero diagonal (the graph smooth_bounds starts from)."""
        lo_b, hi_b, mask_b = _restraint_rows(restraints, r0, Lb)
        target = hi_b if two_sided else 0.5 * (lo_b + hi_b)
        w_rows = torch.where(mask_b > 0, target, torch.full_like(target, _BIG))
        rows = r0 + torch.arange(Lb, device=dev)
        adjacent = (rows[:, None] - cols[None, :]).abs() == 1
        if bead_mask is not None:
            adjacent = adjacent & ((bead_mask[r0:r0 + Lb, None] * bead_mask[None, :]) > 0)
        w_rows = torch.where(adjacent, torch.clamp_max(w_rows, bond_length), w_rows)
        return torch.where(rows[:, None] == cols[None, :], torch.zeros_like(w_rows),
                           w_rows)

    delta = chain_metric_rows(lidx, L, bond_length)
    # the last strip starts at L - Lb: its overlap with the previous strip
    # recomputes identical candidates
    r0s = [min(r0, L - Lb) for r0 in range(0, L, Lb)]
    for _ in range(n_iters):
        cand = torch.full_like(delta, _BIG)
        for r0 in r0s:
            cand = torch.minimum(cand, relax_landmarks_block(delta, edge_rows(r0), r0))
        delta = torch.minimum(delta, cand)
    if not two_sided:
        return delta, lidx

    def lo_rows(r0: int) -> torch.Tensor:
        lo_b, _, mask_b = _restraint_rows(restraints, r0, Lb)
        if bead_mask is not None:
            mask_b = mask_b * (bead_mask[r0:r0 + Lb, None] * bead_mask[None, :])
        return torch.where(mask_b > 0, lo_b, torch.zeros_like(lo_b))

    # the direct bounds on the k landmark rows: gathers, no (L, L) tensor
    if isinstance(restraints, ExactRestraints):
        lo_direct = restraints.target[lidx].to(delta.dtype)
        mask_land = (restraints.w[lidx] > 0).to(delta.dtype)
    else:
        lo_direct = restraints.lo[lidx].to(delta.dtype)
        mask_land = restraints.mask[lidx].to(delta.dtype)
    if bead_mask is not None:
        mask_land = mask_land * (bead_mask[lidx][:, None] * bead_mask[None, :])
    lo_land = torch.where(mask_land > 0, lo_direct, torch.zeros_like(lo_direct))
    # one sweep is the fixed point: the sweep reads the lo matrix, which
    # never updates (only the k landmark rows are tracked)
    for _ in range(lower_iters):
        cand = torch.full_like(delta, -_BIG)
        for r0 in r0s:
            cand = torch.maximum(cand, relax_landmarks_lower_block(delta, lo_rows(r0), r0))
        lo_land = torch.maximum(lo_land, cand)
    return clip_landmark_targets(delta, lo_land, mask_land), lidx


def landmark_init(restraints, bond_length: float = 3.8, k: int = 64,
                  n_iters: int = 4, bead_mask: Optional[torch.Tensor] = None,
                  two_sided: bool = False) -> torch.Tensor:
    """Landmark-MDS embedding -> (L, 3) float32 on the restraints' device,
    padding rows zero; the init for L >= 2048, where classical MDS's
    O(L^3 log L) smoothing would dominate the solve. two_sided: see
    landmark_targets."""
    delta, lidx = landmark_targets(restraints, bond_length, k, n_iters, bead_mask,
                                   two_sided)
    x = landmark_triangulate(delta, lidx)
    if bead_mask is not None:
        x = x * bead_mask[:, None]
    return x.to(torch.float32)


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
