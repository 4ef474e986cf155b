"""Model-quality metrics — the port's copy of chromosome3d_tpu/metrics.py's
host functions: Spearman rank correlation of IF against model distances
(spearman_IF_pdb.pl:15-76), Kabsch RMSD, the clash count, and the
cross-resolution similarity behind output_models/similarity.txt (Spearman
and scale-optimal dRMSD between a reduced high-resolution model and a
low-resolution one).

All math here is host-side numpy/scipy: scoring is O(L^2 log L) scalar work
on finished models. The strip helpers (ROW_CHUNK, d2_row_strip) are the
at-scale building block shared with assess.py.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

def rank_average_ties(v: np.ndarray) -> np.ndarray:
    """1-based ranks with ties assigned the average rank (the convention of
    Statistics::RankCorrelation used by spearman_IF_pdb.pl:65-70)."""
    v = np.asarray(v)
    s = np.sort(v)
    left = np.searchsorted(s, v, side="left")
    right = np.searchsorted(s, v, side="right")
    return (left + right + 1).astype(np.float64) / 2.0


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation with average-tie ranks."""
    return pearson(rank_average_ties(a), rank_average_ties(b))


# beyond this many qualifying ORDERED pairs the statistic is estimated on a
# fixed-seed uniform pair subsample of this size (the reference's 663-bead
# cap tops out ~440k ordered pairs, always exact; a 4M-pair estimate of a
# rank correlation has standard error ~1/sqrt(4M) ~ 0.0005)
SPEARMAN_MAX_PAIRS = 4_000_000


def _spearman_pairs(if_matrix: np.ndarray, L: int, rng: int):
    """The pairs the statistic runs over for a model of L beads — a boolean
    (L, L) mask of the ordered pairs with |i-j| >= rng, or past
    SPEARMAN_MAX_PAIRS the (i, j) index arrays of the fixed-seed subsample —
    and the IF values' ranks there, centred. Model-independent: an ensemble
    ranks its IF values once."""
    from scipy import stats as sps

    if rng >= L:
        raise ValueError("range >= model length (ref prints '-' and exits)")
    # ordered pairs with |i-j| >= rng
    n_pairs = L * L - (L + sum(2 * (L - k) for k in range(1, rng)))
    if n_pairs > SPEARMAN_MAX_PAIRS:
        rs = np.random.RandomState(20260818)
        m = SPEARMAN_MAX_PAIRS
        i = rs.randint(0, L, size=2 * m)
        j = rs.randint(0, L, size=2 * m)
        keep = np.abs(i - j) >= rng
        pairs = (i[keep][:m], j[keep][:m])
        # index before converting: a whole-matrix float64 copy of an
        # at-scale input (possibly a read-only f32 .npy memmap) is tens of
        # GB on exactly the path this sampled branch exists for
        iv = np.asarray(if_matrix[pairs], dtype=np.float64)
    else:
        idx = np.arange(L)
        pairs = np.abs(idx[:, None] - idx[None, :]) >= rng
        iv = np.asarray(if_matrix, dtype=np.float64)[:L, :L][pairs]
    ra = sps.rankdata(iv)
    ra -= ra.mean()
    return pairs, ra


def _quantized_ranks(dv: np.ndarray) -> np.ndarray:
    """scipy.stats.rankdata(dv) (average ranks of ties), bit for bit, for
    distances rounded to 0.001: each is k / 1000 for an integer k that
    rint(1000 dv) recovers, so the ranks come from a count of each k
    instead of a sort. Values that are not finite, or k past a few times
    the count of values, take rankdata itself."""
    from scipy import stats as sps

    if dv.size == 0 or not np.isfinite(dv).all() or dv.max() * 1000 > 4 * dv.size + 2**20:
        return sps.rankdata(dv)
    k = np.rint(dv * 1000).astype(np.int64)
    counts = np.bincount(k)
    upto = np.cumsum(counts)      # values <= k
    return 0.5 * (upto[k] + (upto - counts)[k] + 1)


def _spearman_model(pairs, ra: np.ndarray, coords: np.ndarray) -> float:
    """Spearman(IF, d) of one model over _spearman_pairs' pairs and IF ranks."""
    coords = np.asarray(coords, dtype=np.float64)
    if isinstance(pairs, tuple):
        i, j = pairs
        dv = np.sqrt(((coords[i] - coords[j]) ** 2).sum(-1))
    else:
        dv = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)[pairs]
    # the reference quantizes model distances to %.3f before ranking (:46)
    rb = _quantized_ranks(np.round(dv, 3))
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else 0.0


def spearman_if_model(
    if_matrix: np.ndarray, coords: np.ndarray, rng: int = 3
) -> float:
    """The spearman_IF_pdb.pl statistic: Spearman(IF_ij, d_ij) over all
    ordered pairs with |i-j| >= rng (spearman_IF_pdb.pl:42-70).
    Negative values are good (high IF <-> short distance).

    Beyond SPEARMAN_MAX_PAIRS qualifying pairs (L ~ 2000+) the statistic is
    computed on a deterministic uniform subsample of that many pairs."""
    return _spearman_model(*_spearman_pairs(if_matrix, np.shape(coords)[0], rng), coords)


def spearman_if_inv_d(if_matrix: np.ndarray, coords: np.ndarray, rng: int = 3) -> float:
    """The headline quality metric Spearman(IF, 1/d). Equals
    -spearman_if_model because 1/d reverses the rank order of d."""
    return -spearman_if_model(if_matrix, coords, rng)


def spearman_if_inv_d_ensemble(if_matrix: np.ndarray, coords: np.ndarray,
                               rng: int = 3) -> np.ndarray:
    """spearman_if_inv_d of every model of an (n, L, 3) ensemble, the IF
    values ranked once for all of them; each value equals the one-model
    call's bit for bit."""
    coords = np.asarray(coords)
    pairs, ra = _spearman_pairs(if_matrix, coords.shape[1], rng)
    return np.asarray([-_spearman_model(pairs, ra, c) for c in coords])


def kabsch_rmsd(
    a: np.ndarray,
    b: np.ndarray,
    allow_mirror: bool = True,
    allow_scale: bool = False,
) -> float:
    """RMSD of a onto b after optimal superposition.

    allow_mirror: chromosome reconstructions have arbitrary chirality (the
    distance-only energy is mirror-symmetric), so cross-model comparison
    must try both hands.
    allow_scale: optional uniform scaling (Procrustes).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]

    def one(a):
        ac = a - a.mean(0)
        bc = b - b.mean(0)
        h = ac.T @ bc
        u, s, vt = np.linalg.svd(h)
        d = np.sign(np.linalg.det(u @ vt))
        corr = np.diag([1.0, 1.0, d])
        r = u @ corr @ vt
        if allow_scale:
            num = (s * np.diag(corr)).sum()
            den = (ac * ac).sum()
            scale = num / den if den > 0 else 1.0
        else:
            scale = 1.0
        diff = scale * (ac @ r) - bc
        return float(np.sqrt((diff * diff).sum() / n))

    r1 = one(a)
    if not allow_mirror:
        return r1
    return min(r1, one(a * np.array([-1.0, 1.0, 1.0])))


def drmsd(a: np.ndarray, b: np.ndarray, fit_scale: bool = True) -> float:
    """Distance-matrix RMSD: sqrt(mean((s*d_a - d_b)^2)) over unordered
    pairs, with optional least-squares scale s. Superposition-free and
    mirror-invariant (chirality cannot be distinguished from distances)."""
    a, b = np.asarray(a), np.asarray(b)
    n = min(len(a), len(b))
    da = np.linalg.norm(a[:n, None] - a[None, :n], axis=-1)
    db = np.linalg.norm(b[:n, None] - b[None, :n], axis=-1)
    iu = np.triu_indices(n, k=1)
    da, db = da[iu], db[iu]
    s = (da * db).sum() / max((da * da).sum(), 1e-30) if fit_scale else 1.0
    return float(np.sqrt(((s * da - db) ** 2).mean()))


def cross_resolution_similarity(
    hi_res: np.ndarray, lo_res: np.ndarray, factor: int = 2
) -> Tuple[float, float]:
    """The similarity.txt protocol (output_models/similarity.txt): reduce the
    high-res model by bead-pair averaging (io.pdb.reduce_model), then report
      * Spearman between the two models' pairwise-distance sets, and
      * scale-optimal dRMSD.
    Returns (spearman, rmsd)."""
    from scipy import stats as sps

    from chromosome3d_tpu_torch.io.pdb import reduce_model

    red = reduce_model(np.asarray(hi_res), factor)
    lo = np.asarray(lo_res)
    n = min(len(red), len(lo))
    red, lo = red[:n], lo[:n]
    d1 = np.linalg.norm(red[:, None] - red[None, :], axis=-1)
    d2 = np.linalg.norm(lo[:, None] - lo[None, :], axis=-1)
    iu = np.triu_indices(n, k=1)
    rho = float(sps.spearmanr(d1[iu], d2[iu]).statistic)
    return rho, drmsd(red, lo, fit_scale=True)


_CLASH_CHUNK_MIN_L = 4096
ROW_CHUNK = 512


def d2_row_strip(coords: np.ndarray, r0: int, r1: int) -> np.ndarray:
    """Rows [r0, r1) of the squared pairwise-distance matrix as a float64
    (r1-r0, L) strip, accumulated per axis: never materializes an (L, L, 3)
    diff tensor. coords must already be float64 — callers cast once, not
    per strip."""
    a = coords[r0:r1]
    d2 = np.zeros((r1 - r0, len(coords)))
    for ax in range(3):
        dc = a[:, ax][:, None] - coords[:, ax][None, :]
        d2 += dc * dc
    return d2


def clash_count(coords: np.ndarray, threshold: float) -> int:
    """Number of bead pairs closer than threshold (ref clash_count :693-714).
    Row-chunked beyond L = 4096: the full (L, L, 3) diff tensor is multi-GB
    on the at-scale path (exact count either way)."""
    coords = np.asarray(coords)
    L = len(coords)
    if L <= _CLASH_CHUNK_MIN_L:
        d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
        iu = np.triu_indices(L, k=1)
        return int((d[iu] <= threshold).sum())
    coords = coords.astype(np.float64)
    count = 0
    cols = np.arange(L)
    t2 = float(threshold) ** 2
    for r0 in range(0, L, ROW_CHUNK):
        r1 = min(r0 + ROW_CHUNK, L)
        d2 = d2_row_strip(coords, r0, r1)
        triu = cols[None, :] > np.arange(r0, r1)[:, None]
        count += int(((d2 <= t2) & triu).sum())
    return count
