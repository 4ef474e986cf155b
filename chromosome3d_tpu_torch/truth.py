"""Ground-truth scoring — the port's copy of chromosome3d_tpu/truth.py's
host functions: a known 3D structure (a confined persistent random walk),
the IF matrix the pipeline's conversion implies for it
(d = K * mean(IF^alpha) / IF^alpha, chromosome3D.pl:110-162, inverted:
IF = (1/d)^(1/alpha)), and the reconstruction metrics against the truth.
Host numpy, seed-deterministic; at scale the IF matrix is built in row
strips on the device (if_from_structure_strips), as the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from chromosome3d_tpu_torch.device import resolve_device
from chromosome3d_tpu_torch.metrics import kabsch_rmsd


def confined_walk(
    L: int,
    seed: int = 0,
    bond: float = 3.8,
    radius_factor: float = 0.75,
    persistence: float = 0.7,
) -> np.ndarray:
    """A confined persistent random walk: (L, 3) float64 coordinates.

    bond: step length (the solver's default bond_length, so reconstructions
    are commensurate without rescaling).
    radius_factor: confinement sphere radius = radius_factor * bond *
    L**(1/3) — constant bead density across L.
    persistence: direction memory in [0, 1); 0 = pure random walk.
    """
    rs = np.random.RandomState(seed)
    R = radius_factor * bond * L ** (1.0 / 3.0)
    x = np.zeros((L, 3))
    d = _unit(rs.randn(3))
    for i in range(1, L):
        d = _unit(persistence * d + (1.0 - persistence) * _unit(rs.randn(3)))
        nxt = x[i - 1] + bond * d
        r = np.linalg.norm(nxt)
        if r > R:
            # reflect the direction off the (spherical) wall and retake
            # the step; the rare double-violation clamps to the boundary
            n = nxt / r
            d = _unit(d - 2.0 * float(d @ n) * n)
            nxt = x[i - 1] + bond * d
            r = np.linalg.norm(nxt)
            if r > R:
                nxt *= R / r
        x[i] = nxt
    return x - x.mean(axis=0)


def _unit(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else np.array([1.0, 0.0, 0.0])


def radius_of_gyration(coords: np.ndarray) -> float:
    c = np.asarray(coords, dtype=np.float64)
    c = c - c.mean(axis=0)
    return float(np.sqrt((c * c).sum(axis=1).mean()))


def if_from_structure(
    coords: np.ndarray,
    alpha: float = 0.5,
    noise_sigma: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """(L, L) float64 IF matrix from true coordinates.

    IF_ij = (1/d_ij)^(1/alpha) * exp(noise_sigma * g_ij) with g symmetric
    standard normal — under the pipeline's conversion this recovers d_hat
    proportional to d_true * exp(-alpha * noise_sigma * g). The diagonal
    uses a bond-scale floor (huge IF, like real matrices).
    """
    c = np.asarray(coords, dtype=np.float64)
    L = c.shape[0]
    d = np.linalg.norm(c[:, None] - c[None, :], axis=-1)
    floor = 0.5 * 3.8
    np.fill_diagonal(d, floor)
    d = np.maximum(d, floor)
    m = (1.0 / d) ** (1.0 / alpha)
    if noise_sigma > 0.0:
        rs = np.random.RandomState(seed + 1)
        g = rs.standard_normal((L, L))
        g = np.triu(g, 1)
        g = g + g.T                      # symmetric, zero diagonal
        m = m * np.exp(noise_sigma * g)
    return m


def if_from_structure_strips(
    coords: np.ndarray,
    alpha: float = 0.5,
    noise_sigma: float = 0.0,
    seed: int = 0,
    strip: int = 2048,
    out: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """if_from_structure for at-scale L, on `device` (device.resolve_device:
    None is the first CUDA device): the (L, 3) truth is uploaded once, then
    (strip, L) float32 rows are computed on the device and downloaded, so
    the host runs no O(L^2) pass and the device holds one strip. out: an
    optional preallocated or memmapped (L, L) float32 array to fill.

    The noise is a symmetric counter hash (_hash_normal of (min(i, j),
    max(i, j), seed + 1)), so a value depends on its position only and the
    strips are independent: the JAX package's words bit for bit."""
    dev = resolve_device(device)
    c = torch.tensor(np.asarray(coords, dtype=np.float32), device=dev)
    L = c.shape[0]
    S = min(strip, L)
    floor = float(np.float32(0.5 * 3.8))
    inv_alpha = float(np.float32(1.0 / alpha))
    j = torch.arange(L, device=dev)[None, :]
    if out is None:
        out = np.empty((L, L), dtype=np.float32)
    for r0 in range(0, L, S):
        n = min(S, L - r0)
        rows = c[r0:r0 + n]
        d2 = torch.zeros((n, L), dtype=torch.float32, device=dev)
        for k in range(3):
            dk = rows[:, k, None] - c[None, :, k]
            d2 += dk * dk
        m = torch.pow(1.0 / torch.clamp_min(torch.sqrt(d2), floor), inv_alpha)
        if noise_sigma > 0.0:
            i = torch.arange(r0, r0 + n, device=dev)[:, None]
            g = _hash_normal(torch.minimum(i, j), torch.maximum(i, j), seed + 1)
            g = torch.where(i == j, torch.zeros_like(g), g)
            m = m * torch.exp(float(np.float32(noise_sigma)) * g)
        out[r0:r0 + n] = m.cpu().numpy()
    return out


_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """x * k mod 2^32 for int64 x in [0, 2^32) and a constant k < 2^32, in
    two 16-bit halves of k so that no product leaves int64."""
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _hash_words(lo: torch.Tensor, hi: torch.Tensor, seed: int):
    """The two uint32 words of the counter hash at (lo, hi), held in int64:
    the JAX package's xorshift-multiply mix of lo * 2654435761 + hi * 40503
    + seed * 2246822519 (mod 2^32), and of the same base ^ 0x9E3779B9."""
    base = (_mul32(lo, 2654435761) + _mul32(hi, 40503)
            + (int(seed) * 2246822519 & _MASK32)) & _MASK32
    return _mix32(base), _mix32(base ^ 0x9E3779B9)


def _hash_normal(lo: torch.Tensor, hi: torch.Tensor, seed: int) -> torch.Tensor:
    """A symmetric deterministic standard normal from integer coordinates
    (int64 tensors of values < 2^32): the two hash words as uniforms in
    (0, 1] and [0, 1), then Box-Muller, in float32."""
    u1, u2 = _hash_words(lo, hi, seed)
    f1 = (u1.to(torch.float32) + 1.0) * float(2.0 ** -32)
    f2 = u2.to(torch.float32) * float(2.0 ** -32)
    return torch.sqrt(-2.0 * torch.log(f1)) * torch.cos(
        float(np.float32(2.0 * np.pi)) * f2)


def reconstruction_metrics(
    rec: np.ndarray,
    true: np.ndarray,
    n_pairs: int = 2_000_000,
    seed: int = 0,
) -> Dict[str, float]:
    """Score a reconstruction against the TRUE structure. Returns:

      rmsd_over_rg : Kabsch superposition RMSD (mirror resolved, and
                     scale-optimal, since the IF->distance map fixes scale
                     only up to K*mean), divided by the truth's radius of
                     gyration. 0 = exact.
      spearman_d   : Spearman between reconstructed and true pair
                     distances (subsampled beyond n_pairs unordered pairs,
                     fixed seed). 1 = perfect rank recovery.
      drmsd_rel    : scale-optimal dRMSD over the same pairs, divided by
                     the mean true distance.
    """
    from scipy import stats as sps

    a = np.asarray(rec, dtype=np.float64)
    b = np.asarray(true, dtype=np.float64)
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]

    rmsd = kabsch_rmsd(a, b, allow_mirror=True, allow_scale=True)
    rg = radius_of_gyration(b)

    total = n * (n - 1) // 2
    if total > n_pairs:
        rs = np.random.RandomState(seed + 20260820)
        i = rs.randint(0, n, size=int(2.2 * n_pairs))
        j = rs.randint(0, n, size=int(2.2 * n_pairs))
        keep = i < j
        i, j = i[keep][:n_pairs], j[keep][:n_pairs]
    else:
        i, j = np.triu_indices(n, k=1)
    da = np.sqrt(((a[i] - a[j]) ** 2).sum(-1))
    db = np.sqrt(((b[i] - b[j]) ** 2).sum(-1))
    rho = float(sps.spearmanr(da, db).statistic)
    s = float((da * db).sum() / max((da * da).sum(), 1e-30))
    drmsd_rel = float(np.sqrt(((s * da - db) ** 2).mean()) / db.mean())
    return {
        "rmsd_over_rg": float(rmsd / rg),
        "spearman_d": rho,
        "drmsd_rel": drmsd_rel,
        "n_pairs": int(len(i)),
    }
