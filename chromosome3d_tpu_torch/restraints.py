"""IF matrix -> distance restraints, and the restraint files — the port's
own copy of chromosome3d_tpu/restraints.py (float64 numpy on the host; the
`.rr` and `contact.tbl` writers take the native C++ path,
chromosome3d_tpu_torch.native, where its library builds, as the JAX
package's do), so the restraint tensors and the `.rr` / `contact.tbl` text
artifacts are byte-equal between the two packages.

Reference semantics (reproduced bit-for-bit on the text artifacts):

  * IF2dist_new (chromosome3D.pl:110-162):
        x_ij = IF_ij ** alpha
        m    = mean(x) over all L*L cells
        d_ij = K / (x_ij / m) = K * m / IF_ij**alpha,  with IF==0 -> sentinel -1

  * dist2rr (chromosome3D.pl:181-206): upper triangle j > i only, skip
    |i-j| < separation and d <= 0; rows "i j d d 1.0" (1-based, %.2f),
    sorted by *string* key.

  * carr2tbl (chromosome3D.pl:340-362): distance=(lo+hi)/2, negdev=posdev=
    (hi-lo)/2; the literal string "0" as lo triggers the (3.6, 0.1, hi-3.6)
    special case. Emits the (typo'd but CNS-tolerated) `assign45` token.

The solver consumes a dense (L, L) target-distance matrix plus a dense mask
rather than a ragged list of restraints.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from chromosome3d_tpu_torch import native
from chromosome3d_tpu_torch.config import RestraintConfig

__all__ = ["OrGroups", "Restraints", "build_restraints", "dist_to_restraints",
           "if_to_dist", "quantize_dist", "read_contact_tbl_full", "read_rr",
           "restraints_from_exact_target", "write_contact_tbl", "write_rr"]


@dataclasses.dataclass(frozen=True)
class Restraints:
    """Dense restraint tensors for one chromosome.

    target: (L, L) float32 — restraint center distance d_ij (symmetric);
            undefined where mask is False.
    negdev/posdev: (L, L) float32 — allowed deviation below/above target
            (zero for this pipeline's exact restraints; the carr2tbl zero-lo
            case produces nonzero deviations).
    mask:   (L, L) bool — True where a restraint exists (symmetric, i != j).
    """

    target: np.ndarray
    negdev: np.ndarray
    posdev: np.ndarray
    mask: np.ndarray

    @property
    def length(self) -> int:
        return self.target.shape[0]

    @property
    def count(self) -> int:
        """Number of restraints (upper-triangle count, matches contact.tbl rows)."""
        return int(np.triu(self.mask, k=1).sum())

    def padded(self, L_pad: int) -> "Restraints":
        """Zero-pad all tensors to (L_pad, L_pad); padding is masked out."""
        L = self.length
        if L_pad < L:
            raise ValueError(f"cannot pad {L} down to {L_pad}")
        if L_pad == L:
            return self

        def pad(a, fill=0):
            out = np.full((L_pad, L_pad), fill, dtype=a.dtype)
            out[:L, :L] = a
            return out

        return Restraints(
            target=pad(self.target),
            negdev=pad(self.negdev),
            posdev=pad(self.posdev),
            mask=pad(self.mask, fill=False),
        )


def if_to_dist(if_matrix: np.ndarray, cfg: RestraintConfig) -> np.ndarray:
    """Vectorized IF2dist_new: d = K * mean(IF^alpha) / IF^alpha, 0 -> -1."""
    m = np.asarray(if_matrix, dtype=np.float64)
    x = np.power(m, cfg.alpha)
    mean = x.mean()
    with np.errstate(divide="ignore"):
        d = cfg.kscaling * mean / x
    d = np.where(x == 0.0, -1.0, d)
    return d


def quantize_dist(dist: np.ndarray) -> np.ndarray:
    """The `.dist` file round-trip: IF2dist_new writes '%.1f' cells
    (chromosome3D.pl:156-161) and dist2rr re-reads that file (:187-199), so
    every downstream consumer sees 1-decimal-quantized distances.

    Must be bit-exact with the formatted artifact (byte parity is
    oracle-tested against the reference's Perl): np.round(d*10)/10 agrees
    with '%.1f' everywhere except when d*10 lands within an ulp of a .5
    decimal midpoint, so those rare cells take the exact text round-trip
    while the bulk stays vectorized (the text path alone costs minutes at
    L ~ 10^4)."""
    d = np.asarray(dist, dtype=np.float64)
    scaled = d * 10.0
    q = np.round(scaled) / 10.0
    frac = np.abs(scaled - np.floor(scaled) - 0.5)
    suspect = frac < 1e-8 * np.maximum(np.abs(scaled), 1.0)
    if suspect.any():
        exact = np.char.mod("%.1f", d[suspect]).astype(np.float64)
        q = q.copy()
        q[suspect] = exact
    return q


def dist_to_restraints(dist: np.ndarray, cfg: RestraintConfig) -> Restraints:
    """Vectorized dist2rr + carr2tbl: dense target/mask tensors.

    Matches the text pipeline including its %.1f quantization through the
    .dist file (the rr, the tbl, and the solver all consume the 1-decimal
    value; distances under 0.05 round to 0.0 and are dropped by dist2rr's
    `d <= 0` skip, chromosome3D.pl:192), so our dense tensors agree byte-wise
    with artifacts regenerated by the reference code (tests/test_perl_oracle).
    """
    d = quantize_dist(dist)
    L = d.shape[0]
    i = np.arange(L)
    sep_ok = np.abs(i[None, :] - i[:, None]) >= cfg.separation
    mask = sep_ok & (d > 0.0)
    mask &= ~np.eye(L, dtype=bool)
    dq = d
    target = np.where(mask, dq, 0.0)
    negdev = np.zeros_like(target)
    posdev = np.zeros_like(target)
    # carr2tbl zero-lo special case: lo == "0" -> (3.6, 0.1, hi - 3.6).
    # dist2rr always emits lo == hi with %.2f, so the literal "0" only occurs
    # for a true 0.00 (excluded by d > 0) — kept for general rr-file input.
    zero_lo = mask & (dq == 0.0)
    target = np.where(zero_lo, cfg.zero_lo_distance, target)
    negdev = np.where(zero_lo, cfg.zero_lo_negdev, negdev)
    posdev = np.where(zero_lo, dq - cfg.zero_lo_distance, posdev)
    # symmetric tensors (upper triangle is authoritative)
    ut = np.triu(np.ones((L, L), dtype=bool), k=1)
    mask = mask & ut
    mask = mask | mask.T
    target = np.where(mask, np.triu(target) + np.triu(target, 1).T, 0.0)
    negdev = np.where(mask, np.triu(negdev) + np.triu(negdev, 1).T, 0.0)
    posdev = np.where(mask, np.triu(posdev) + np.triu(posdev, 1).T, 0.0)
    return Restraints(
        target=target.astype(np.float32),
        negdev=negdev.astype(np.float32),
        posdev=posdev.astype(np.float32),
        mask=mask,
    )


def build_restraints(if_matrix: np.ndarray, cfg: RestraintConfig) -> Restraints:
    """Full L3 stage: IF matrix -> dense restraint tensors."""
    return dist_to_restraints(if_to_dist(if_matrix, cfg), cfg)


def restraints_from_exact_target(target: np.ndarray) -> Restraints:
    """Host Restraints view over a device-built EXACT target matrix
    (ops.device_prep: quantized targets are >= 0.1 wherever a restraint
    exists, exactly 0 elsewhere; matrix-derived restraints are exact by
    construction — dist2rr always emits lo == hi, chromosome3D.pl:203-205,
    so the carr2tbl zero-lo case cannot occur).

    Used by the at-scale matrix paths for assessment/reporting after a
    device-prep solve: one f32 download instead of re-running the float64
    host prep. negdev/posdev are read-only
    zero broadcast views — a written zeros pass would itself be an O(L^2)
    host pass."""
    target = np.asarray(target, np.float32)
    zeros = np.broadcast_to(np.float32(0.0), target.shape)
    return Restraints(
        target=target,
        negdev=zeros,
        posdev=zeros,
        mask=target > 0.0,
    )


# ---------------------------------------------------------------------------
# Reference-compatible text artifacts
# ---------------------------------------------------------------------------

def write_rr(path: str | os.PathLike, dist: np.ndarray, cfg: RestraintConfig) -> int:
    """Write the `$ID.rr` artifact: 'i j d d 1.0' rows (1-based), upper
    triangle, |i-j| >= separation, d > 0, sorted by string key exactly like
    the reference's `sort keys %distances` (chromosome3D.pl:203-205).

    Distances pass through the %.1f `.dist`-file quantization first, exactly
    as the reference's dist2rr does by re-reading the written file — byte
    parity is oracle-tested against the reference's own Perl subs."""
    d = quantize_dist(dist)
    ii, jj = np.nonzero(np.triu(d > 0.0, k=1))
    keep = np.abs(jj - ii) >= cfg.separation
    i1 = (ii[keep] + 1).astype(np.int64)
    j1 = (jj[keep] + 1).astype(np.int64)
    vv = d[ii[keep], jj[keep]]
    # the reference's `sort keys %distances` is a STRING sort of "i j" keys
    # (chromosome3D.pl:203-205); numpy '<U' argsort uses the same code-point
    # order, vectorized
    keys = np.char.add(np.char.add(i1.astype("U11"), " "), j1.astype("U11"))
    order = np.argsort(keys, kind="stable")
    i1, j1, vv = i1[order], j1[order], vv[order]
    if not native.write_rr_rows(path, i1, j1, vv):
        with open(path, "w") as f:
            for i, j, v in zip(i1.tolist(), j1.tolist(), vv.tolist()):
                f.write(f"{i} {j} {v:.2f} {v:.2f} 1.0\n")
    return len(vv)


def write_contact_tbl(
    path: str | os.PathLike, rr_path: str | os.PathLike, cfg: RestraintConfig
) -> int:
    """carr2tbl: rr rows -> CNS NOE tbl rows (chromosome3D.pl:340-362)."""
    n_native = native.rr_to_tbl(
        rr_path, path, cfg.zero_lo_distance, cfg.zero_lo_negdev
    )
    if n_native is not None:
        return n_native
    n = 0
    with open(rr_path, "r") as rf, open(path, "w") as tf:
        for line in rf:
            line = line.strip()
            if not line or not line[0].isdigit():
                continue
            c = line.split()
            lo, hi = c[2], c[3]
            distance = (float(hi) + float(lo)) / 2
            negdev = (float(hi) - float(lo)) / 2
            posdev = negdev
            if lo == "0":
                distance = cfg.zero_lo_distance
                negdev = cfg.zero_lo_negdev
                posdev = float(hi) - cfg.zero_lo_distance
            tf.write(
                f"assign45 (resid {int(c[0]):3d} and name ca) "
                f"(resid {int(c[1]):3d} and name ca) "
                f"{distance:.2f} {negdev:.2f} {posdev:.2f}\n"
            )
            n += 1
    return n


def read_rr(path: str | os.PathLike, L: Optional[int] = None,
            cfg: Optional[RestraintConfig] = None,
            max_L: Optional[int] = None) -> Tuple["Restraints", np.ndarray]:
    """Parse a CASP/CONFOLD-style rr file ('i j lo hi confidence' rows,
    1-based) into dense tensors, applying carr2tbl's conversion semantics
    (chromosome3D.pl:340-362): target=(lo+hi)/2, devs=(hi-lo)/2, and the
    literal-zero lower bound -> (3.6, 0.1, hi-3.6) special case. The
    confidence column becomes the per-restraint weight. L defaults to the
    largest residue index.

    max_L: raise ValueError when the (explicit or inferred) L exceeds it —
    BEFORE the (L, L) tensors are allocated, so a caller cannot be made to
    allocate an enormous matrix by a file naming a huge residue index.

    Vectorized: rows parse in one numpy pass (the zero-lo special case
    keys on the LITERAL token "0", matching the Perl string compare).
    Duplicate (i, j) rows keep last-writer-wins order like the original
    per-row loop (np.add-free fancy-indexed assignment is sequential)."""
    cfg = cfg or RestraintConfig()
    tok_i, tok_j, tok_lo, tok_hi, tok_conf = [], [], [], [], []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or not line[0].isdigit():
                continue
            c = line.split()
            tok_i.append(c[0])
            tok_j.append(c[1])
            tok_lo.append(c[2])
            tok_hi.append(c[3])
            tok_conf.append(c[4] if len(c) > 4 else "1.0")
    if not tok_i:
        L = L or 0
        if max_L is not None and L > max_L:
            raise ValueError(f"{path}: L={L} exceeds the cap {max_L}")
        z = np.zeros((L, L), np.float32)
        return (
            Restraints(target=z, negdev=z.copy(), posdev=z.copy(),
                       mask=np.zeros((L, L), bool)),
            np.zeros((L, L), np.float32),
        )
    ii = np.asarray(tok_i, dtype=np.int64) - 1
    jj = np.asarray(tok_j, dtype=np.int64) - 1
    lo_v = np.asarray(tok_lo, dtype=np.float64)
    hi_v = np.asarray(tok_hi, dtype=np.float64)
    conf_v = np.asarray(tok_conf, dtype=np.float64)
    d = (lo_v + hi_v) / 2
    neg = (hi_v - lo_v) / 2
    pos = neg.copy()
    zero_lo = np.asarray([t == "0" for t in tok_lo])
    d[zero_lo] = cfg.zero_lo_distance
    neg[zero_lo] = cfg.zero_lo_negdev
    pos[zero_lo] = hi_v[zero_lo] - cfg.zero_lo_distance
    max_idx = int(max(ii.max(), jj.max())) + 1
    if L is None:
        L = max_idx
    if max_L is not None and L > max_L:
        raise ValueError(f"{path}: L={L} exceeds the cap {max_L}")
    target = np.zeros((L, L), np.float32)
    negdev = np.zeros((L, L), np.float32)
    posdev = np.zeros((L, L), np.float32)
    weight = np.zeros((L, L), np.float32)
    mask = np.zeros((L, L), bool)
    # interleave (i, j), (j, i) per row so conflicting duplicate rows
    # resolve in file order exactly like the old per-row loop did
    aa = np.empty(2 * len(ii), np.int64)
    bb = np.empty_like(aa)
    aa[0::2], aa[1::2] = ii, jj
    bb[0::2], bb[1::2] = jj, ii
    rep = np.repeat(np.arange(len(ii)), 2)
    target[aa, bb] = d[rep]
    negdev[aa, bb] = neg[rep]
    posdev[aa, bb] = pos[rep]
    weight[aa, bb] = conf_v[rep]
    mask[aa, bb] = True
    r = Restraints(target=target, negdev=negdev, posdev=posdev, mask=mask)
    return r, weight


@dataclasses.dataclass(frozen=True)
class OrGroups:
    """Ambiguous (`or`-group) tbl restraints as padded numpy arrays.

    Each of the R rows restrains the MINIMUM distance over up to G
    alternative (i, j) bead pairs — the flattened cross product of the row's
    two atom groups (the layouts of chromosome3D.pl:487-554). Host-side twin
    of ops.energy.OrGroupRestraints (dense_or_groups_from_numpy converts)."""

    idx_i: np.ndarray    # (R, G) int32, 0-based
    idx_j: np.ndarray    # (R, G) int32
    member: np.ndarray   # (R, G) float32 validity of each alternative
    lo: np.ndarray       # (R,) float32
    hi: np.ndarray       # (R,) float32
    weight: np.ndarray   # (R,) float32

    @property
    def count(self) -> int:
        return int(self.idx_i.shape[0])


def read_contact_tbl_full(
    path: str | os.PathLike, L: Optional[int] = None, rows=None
) -> Tuple[Restraints, Optional[OrGroups]]:
    """Parse a CNS NOE tbl, `or`-group rows included, into dense pair
    tensors plus (if any rows are ambiguous) padded OrGroups arrays — the
    twin of chromosome3d_tpu.restraints.read_contact_tbl_full. L defaults to
    the largest residue index seen. rows: pre-parsed assess.parse_tbl_rows
    output (a caller that also writes the per-row report parses once)."""
    # imported here: assess imports this module
    from chromosome3d_tpu_torch.assess import parse_tbl_rows

    if rows is None:
        rows = parse_tbl_rows(path)
    if L is None:
        L = max((r for g1, g2, *_ in rows for r, _ in (*g1, *g2)), default=0)
    target = np.zeros((L, L), dtype=np.float32)
    negdev = np.zeros((L, L), dtype=np.float32)
    posdev = np.zeros((L, L), dtype=np.float32)
    mask = np.zeros((L, L), dtype=bool)
    grouped = []
    for g1, g2, d, nd, pd in rows:
        bad = [r for r, _ in (*g1, *g2) if not (1 <= r <= L)]
        if bad:
            # out-of-range indices must error: a gather would clamp them and
            # well the distance to the wrong bead
            raise ValueError(
                f"{path}: restraint references resid {bad[0]} outside 1..{L}"
            )
        if len(g1) == 1 and len(g2) == 1:
            i, j = g1[0][0] - 1, g2[0][0] - 1
            for a, b in ((i, j), (j, i)):
                target[a, b] = d
                negdev[a, b] = nd
                posdev[a, b] = pd
                mask[a, b] = True
        else:
            pairs = [(r1 - 1, r2 - 1) for r1, _ in g1 for r2, _ in g2]
            grouped.append((pairs, d - nd, d + pd))

    og = None
    if grouped:
        R = len(grouped)
        G = max(len(p) for p, _, _ in grouped)
        idx_i = np.zeros((R, G), np.int32)
        idx_j = np.zeros((R, G), np.int32)
        member = np.zeros((R, G), np.float32)
        lo = np.zeros((R,), np.float32)
        hi = np.zeros((R,), np.float32)
        for k, (pairs, lo_k, hi_k) in enumerate(grouped):
            for g, (i, j) in enumerate(pairs):
                idx_i[k, g] = i
                idx_j[k, g] = j
                member[k, g] = 1.0
            lo[k], hi[k] = lo_k, hi_k
        og = OrGroups(idx_i=idx_i, idx_j=idx_j, member=member,
                      lo=lo, hi=hi, weight=np.ones((R,), np.float32))
    return Restraints(target=target, negdev=negdev, posdev=posdev, mask=mask), og


def read_contact_tbl(path: str | os.PathLike, L: int) -> Restraints:
    """Parse a CNS NOE tbl back into dense tensors (ref layout at :360;
    also accepts the standard `assign` token), for assessing an external
    tbl file. Rejects `or`-group rows: a caller that accepts ambiguous
    restraints uses read_contact_tbl_full."""
    r, og = read_contact_tbl_full(path, L)
    if og is not None:
        raise ValueError(
            f"{path} contains {og.count} or-group restraint rows; "
            "use read_contact_tbl_full (the solver wells their group-min "
            "distance via ops.energy.OrGroupRestraints)"
        )
    return r
