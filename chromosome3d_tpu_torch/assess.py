"""Model assessment, ranking and report artifacts — the port's twin of the
subset of chromosome3d_tpu/assess.py that the pipelines' artifact emission
uses (assess_ensemble, the NOE-energy and Spearman rankings, the
contact_violation.txt writer, model_info.log, the coverage and violation
coverage strings, and for external `.tbl` files the row parser, the per-row
violation report and the `assess` subcommand's count against a tbl).

Host-side numpy, copied from the JAX package so that the artifact bytes
stay equal: the JAX module cannot be imported without jax (it names
ops.energy.DenseRestraints as a type), and the JAX package is not changed
for the port. Semantics follow the reference's assess_dgsa
(chromosome3D.pl:769-829) and its helpers.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from chromosome3d_tpu_torch.config import PipelineConfig
from chromosome3d_tpu_torch.metrics import ROW_CHUNK, d2_row_strip, spearman_if_inv_d_ensemble
from chromosome3d_tpu_torch.restraints import Restraints


def assess_ensemble(
    coords: np.ndarray,
    restraints,
    cfg: PipelineConfig,
    bead_mask=None,
) -> Dict[str, np.ndarray]:
    """Vectorized satisfied-count / sum-dev for (n, L, 3) coords.

    Pure host-side numpy over the restrained pairs only, at the
    chromosome's real (unpadded) length: O(R) scalar work once per
    chromosome. Semantics of the reference's count_satisfied_tbl_rows and
    sum_noe_dev."""
    coords = np.asarray(coords, dtype=np.float64)
    n = coords.shape[0]
    relax, margin = cfg.dist_relax, cfg.sum_dev_margin
    L = coords.shape[1]
    mask = np.asarray(restraints.mask) > 0
    if bead_mask is not None:
        bm = np.asarray(bead_mask) > 0
        mask = mask & bm[:, None] & bm[None, :]
    if mask.sum() // 2 > FULL_REPORT_MAX:
        # at-scale route (~L^2/2 restrained pairs): row-chunked traversal —
        # the gathered-pair form below would allocate multi-GB index/value
        # arrays
        satisfied = np.zeros(n, dtype=int)
        sum_dev = np.zeros(n, dtype=np.float64)
        total = 0
        cols = np.arange(L)
        lo_full = np.asarray(restraints.lo)
        hi_full = np.asarray(restraints.hi)
        for r0 in range(0, L, ROW_CHUNK):
            r1 = min(r0 + ROW_CHUNK, L)
            m = mask[r0:r1] & (cols[None, :] > np.arange(r0, r1)[:, None])
            if not m.any():
                continue
            total += int(m.sum())
            lo_b = lo_full[r0:r1].astype(np.float64)
            hi_b = hi_full[r0:r1].astype(np.float64)
            for k in range(n):
                d = np.sqrt(d2_row_strip(coords[k], r0, r1) + 1e-12)
                satisfied[k] += int(((d < hi_b + relax) & m).sum()) - int(
                    ((d < lo_b - relax) & m).sum()
                )
                over = (d > hi_b + margin) & m
                under = (d < lo_b - margin) & m
                sum_dev[k] += float(
                    ((d - hi_b) * over).sum() + ((lo_b - d) * under).sum()
                )
        return {
            "satisfied": satisfied,
            "total": np.full(n, total, dtype=int),
            "sum_dev": sum_dev,
        }
    lo = np.asarray(restraints.lo, dtype=np.float64)
    hi = np.asarray(restraints.hi, dtype=np.float64)
    mask = np.triu(mask, k=1)
    ii, jj = np.nonzero(mask)
    lo_r, hi_r = lo[ii, jj], hi[ii, jj]
    satisfied = np.zeros(n, dtype=int)
    sum_dev = np.zeros(n, dtype=np.float64)
    for k, c in enumerate(coords):
        diff = c[ii] - c[jj]
        d = np.sqrt((diff * diff).sum(-1) + 1e-12)
        # count_satisfied semantics (ref :447-485): +1 under the relaxed hi,
        # -1 again when too short (credit cancels)
        satisfied[k] = int((d < hi_r + relax).sum()) - int((d < lo_r - relax).sum())
        over = d > hi_r + margin
        under = d < lo_r - margin
        sum_dev[k] = float(((d - hi_r) * over).sum() + ((lo_r - d) * under).sum())
    return {
        "satisfied": satisfied,
        "total": np.full(n, len(ii), dtype=int),
        "sum_dev": sum_dev,
    }


def rank_by_energy(noe_energies: np.ndarray, top_k: int) -> np.ndarray:
    """Indices of the best top_k models by ascending NOE energy — the
    `${ID}_model1..5.pdb` ranking (chromosome3D.pl:796-828)."""
    order = np.argsort(np.asarray(noe_energies), kind="stable")
    return order[:top_k]


def rank_by_spearman(
    if_matrix: np.ndarray, coords: np.ndarray, rng: int = 3
) -> Tuple[np.ndarray, np.ndarray]:
    """Descending Spearman(IF, 1/d) ranking — the publication rankNN order
    (spearman_IF_pdb.pl:73-76, sign-flipped). Returns (order, scores)."""
    scores = spearman_if_inv_d_ensemble(if_matrix, coords, rng)
    return np.argsort(-scores, kind="stable"), scores


def restraint_spec_strings(r: Restraints) -> List[str]:
    """The `assign45 ...` spec column of the violation report, one string per
    upper-triangle restraint. Model-independent — callers emitting reports
    for a whole ensemble compute this ONCE per chromosome and pass it to
    write_violation_report (it is ~60% of the per-row formatting cost)."""
    ii, jj = np.nonzero(np.triu(r.mask, k=1))
    return [
        f"assign45  resid {i:3d} and name ca   resid {j:3d} and name ca  "
        f"{t:.2f} {nd:.2f} {pd:.2f}"
        for i, j, t, nd, pd in zip(
            (ii + 1).tolist(),
            (jj + 1).tolist(),
            r.target[ii, jj].tolist(),
            r.negdev[ii, jj].tolist(),
            r.posdev[ii, jj].tolist(),
        )
    ]


# per-restraint report rows beyond this count switch to violated-rows-only
# (the reference's 663-bead cap tops out ~219k pairs, always below it)
FULL_REPORT_MAX = 500_000


def _violation_report_chunked(
    path, coords, r, cfg, pdb_name, tbl_name, append,
    row_chunk: int = 512,
) -> Tuple[int, int]:
    """write_violation_report's at-scale body (restraint count beyond
    FULL_REPORT_MAX): row-chunked traversal with bounded temporaries.
    Beyond-reference restraint sets are ~L^2/2 pairs — the dense body's
    (L, L, 3) diff tensor and twin ~L^2/2-element index arrays are multi-GB
    host allocations.
    Violated rows only (the dense body's own at-scale policy), identical
    row-major order, identical (satisfied, total) counts."""
    L = coords.shape[0]
    relax = cfg.dist_relax
    satisfied = 0
    total = 0
    out_rows = []  # (i, j, t, nd, pd, dist, dev) of violated rows, in order
    target = np.asarray(r.target)
    negdev = np.asarray(r.negdev)
    posdev = np.asarray(r.posdev)
    mask_full = np.asarray(r.mask)
    cols = np.arange(L)
    for r0 in range(0, L, row_chunk):
        r1 = min(r0 + row_chunk, L)
        m = (mask_full[r0:r1] > 0) & (cols[None, :] > np.arange(r0, r1)[:, None])
        if not m.any():
            continue
        d = np.sqrt(d2_row_strip(coords, r0, r1))
        t = target[r0:r1].astype(np.float64)
        lo = t - negdev[r0:r1]
        hi = t + posdev[r0:r1]
        under_hi = (d < hi + relax) & m
        under_lo = (d < lo - relax) & m
        total += int(m.sum())
        satisfied += int(under_hi.sum()) - int(under_lo.sum())
        viol = m & ~(under_hi & ~under_lo)
        if viol.any():
            vi, vj = np.nonzero(viol)
            pd_v = d[vi, vj]
            lo_v, hi_v = lo[vi, vj], hi[vi, vj]
            dev = np.where(under_lo[vi, vj], -(lo_v - pd_v), pd_v - hi_v)
            out_rows.append((
                vi + r0 + 1, vj + 1, t[vi, vj],
                negdev[r0:r1][vi, vj], posdev[r0:r1][vi, vj], pd_v, dev,
            ))
    lines = []
    for ri, rj, rt, rnd, rpd, rdist, rdev in out_rows:
        lines.extend(
            f"  1\t{dv:.2f}\t{pdist:.2f} # assign45  resid {i:3d} and name ca"
            f"   resid {j:3d} and name ca  {tv:.2f} {ndv:.2f} {pdvv:.2f}\n"
            for i, j, tv, ndv, pdvv, pdist, dv in zip(
                ri.tolist(), rj.tolist(), rt.tolist(), rnd.tolist(),
                rpd.tolist(), rdist.tolist(), rdev.tolist(),
            )
        )
    with open(path, "a" if append else "w") as f:
        f.write(f"#NOE violation check; {pdb_name} against {tbl_name}\n")
        f.write("#violation-flag, deviation, actual-measurement, Input-NOE-restraint\n")
        f.write(
            f"#beyond-reference scale: {total} restraints, listing the "
            f"{len(lines)} violated rows only "
            f"({satisfied}/{total} satisfied)\n"
        )
        f.writelines(lines)
    return satisfied, total


def write_violation_report(
    path: str | os.PathLike,
    coords: np.ndarray,
    r: Restraints,
    cfg: PipelineConfig,
    pdb_name: str = "model",
    tbl_name: str = "contact.tbl",
    append: bool = False,
    specs: Optional[List[str]] = None,
) -> Tuple[int, int]:
    """`contact_violation.txt` (ref count_satisfied_tbl_rows :447-485):
    one row per restraint: violation flag, deviation, actual distance, and
    the restraint spec; violated rows first. Returns (satisfied, total).

    append=True adds this model's report after existing ones — the reference
    appends one report per assessed model into the same file (print2file
    appends, and assess_dgsa calls count_satisfied_tbl_rows per PDB,
    chromosome3D.pl:323-338, 804-810).

    Beyond reference scale (restraint count > FULL_REPORT_MAX; the
    reference caps at 663 beads ~ 219k pairs, always below it) the report
    keeps only the VIOLATED rows plus a summary line — at L=3000 the full
    4-model report measured 1.6 GB of text and dominated the end-to-end
    wall; violated-only keeps the report useful at any scale."""
    # fully vectorized (one report per model, up to ~100k restraints each).
    # Semantics identical to count_satisfied_tbl_rows
    # (chromosome3D.pl:447-485), violated rows first (stable order).
    coords = np.asarray(coords, dtype=np.float64)
    mask_np = np.asarray(r.mask) > 0
    if mask_np.sum() // 2 > FULL_REPORT_MAX:
        # at-scale route: row-chunked traversal — no (L, L, 3) diff tensor,
        # no ~L^2/2-element index arrays, only the violated rows collected
        # (same row-major order the argsort below produces for them)
        return _violation_report_chunked(
            path, coords, r, cfg, pdb_name, tbl_name, append
        )
    diff = coords[:, None, :] - coords[None, :, :]
    d = np.sqrt((diff * diff).sum(-1))
    ii, jj = np.nonzero(np.triu(r.mask, k=1))
    t = r.target[ii, jj].astype(np.float64)
    nd = r.negdev[ii, jj].astype(np.float64)
    pdv = r.posdev[ii, jj].astype(np.float64)
    lo = t - nd
    hi = t + pdv
    pd_ = d[ii, jj]
    under_hi = pd_ < hi + cfg.dist_relax
    under_lo = pd_ < lo - cfg.dist_relax
    flag = np.where(under_hi & ~under_lo, 0, 1)
    dev = np.where(under_lo, -(lo - pd_), np.where(under_hi, 0.0, pd_ - hi))
    satisfied = int(under_hi.sum()) - int(under_lo.sum())
    total = int(len(ii))
    # total == mask.sum()//2 here (restraint masks are symmetric with a
    # zero diagonal by construction — |i-j| >= separation), so the chunked
    # dispatch above guarantees total <= FULL_REPORT_MAX: this body always
    # writes the complete report; violated-only truncation lives solely in
    # _violation_report_chunked.
    order = np.argsort(-flag, kind="stable")
    if specs is None:
        specs = restraint_spec_strings(r)
    spec_sorted = [specs[k] for k in order.tolist()]
    lines = [
        f"{f:3d}\t{dv:.2f}\t{pdist:.2f} # {spec}\n"
        for f, dv, pdist, spec in zip(
            flag[order].tolist(), dev[order].tolist(), pd_[order].tolist(),
            spec_sorted,
        )
    ]
    with open(path, "a" if append else "w") as f:
        f.write(f"#NOE violation check; {pdb_name} against {tbl_name}\n")
        f.write("#violation-flag, deviation, actual-measurement, Input-NOE-restraint\n")
        f.writelines(lines)
    return satisfied, total


def write_tbl_violation_report(
    path: str | os.PathLike,
    coords: np.ndarray,
    tbl_path: str | os.PathLike,
    cfg: PipelineConfig,
    pdb_name: str = "model",
    rows=None,
) -> Tuple[int, int]:
    """Violation report for an ARBITRARY external tbl, one report row per
    TBL ROW — the reference's count_satisfied_tbl_rows iterates the file
    (:447-485), so duplicate rows, reversed (j, i) rows, and `or`-group
    rows (minimum distance over alternatives, :487-554) all count
    individually. Violated rows first across the WHOLE file, like the
    dense writer. Returns (satisfied, total).

    The matrix pipeline's own contact.tbl is unique-upper-triangle by
    construction, so the vectorized dense write_violation_report stays its
    fast path; this writer backs the restraints-file pipeline. rows:
    pre-parsed parse_tbl_rows output (avoids re-reading the file)."""
    coords = np.asarray(coords, dtype=np.float64)
    if rows is None:
        rows = parse_tbl_rows(tbl_path)
    pd_ = tbl_row_distances(coords, rows)
    dt = np.asarray([r[2] for r in rows], np.float64)
    neg = np.asarray([r[3] for r in rows], np.float64)
    pos = np.asarray([r[4] for r in rows], np.float64)
    lo = dt - neg
    hi = dt + pos
    under_hi = pd_ < hi + cfg.dist_relax
    under_lo = pd_ < lo - cfg.dist_relax
    flag = np.where(under_hi & ~under_lo, 0, 1)
    satisfied = int(under_hi.sum()) - int(under_lo.sum())
    total = len(rows)
    dev = np.where(under_lo, -(lo - pd_), np.where(under_hi, 0.0, pd_ - hi))
    order = np.argsort(-flag, kind="stable")   # violated rows first (stable)
    truncated = total > FULL_REPORT_MAX
    if truncated:
        # same at-scale policy as the dense writer: violated rows only plus
        # a summary line (formatting >500k spec strings would dominate)
        order = order[: int(flag.sum())]

    def sel(g):
        if len(g) == 1:
            r, a = g[0]
            return f"(resid {r:3d} and name {a})"
        return (
            "("
            + " or ".join(f"(resid {r:3d} and name {a})" for r, a in g)
            + ")"
        )

    lines = []
    for k in order.tolist():
        g1, g2 = rows[k][0], rows[k][1]
        token = "assign45" if len(g1) == 1 and len(g2) == 1 else "assign"
        spec = f"{token} {sel(g1)} {sel(g2)} {dt[k]:.2f} {neg[k]:.2f} {pos[k]:.2f}"
        lines.append(f"{flag[k]:3d}\t{dev[k]:.2f}\t{pd_[k]:.2f} # {spec}\n")
    with open(path, "w") as f:
        f.write(f"#NOE violation check; {pdb_name} against {os.path.basename(str(tbl_path))}\n")
        f.write("#violation-flag, deviation, actual-measurement, Input-NOE-restraint\n")
        if truncated:
            f.write(
                f"#beyond-reference scale: {total} tbl rows, listing the "
                f"{len(lines)} violated rows only "
                f"({satisfied}/{total} satisfied)\n"
            )
        f.writelines(lines)
    return satisfied, total


def append_model_info(
    path: str | os.PathLike, pdb_path: str, remarks: Dict[str, float]
) -> None:
    """model_info.log: backed-up REMARK rows per model (ref filter_nonCA
    :864-880 writes the source path then its REMARK rows)."""
    with open(path, "a") as f:
        f.write(str(pdb_path))
        for term, value in remarks.items():
            f.write(f"REMARK {term} = {value:.4f}\n")
        f.write("\n")


def coverage_string(r: Restraints) -> str:
    """Restraint-density string (ref coverage_tbl :397-445): one char per
    bead — '-' untouched, 1-9 = restraint count, '*' for 10+. Returns the
    same trailer format: '[<n> restraints touching <k> residues]'."""
    L = r.length
    counts = np.triu(r.mask, k=1).sum(0) + np.triu(r.mask, k=1).sum(1)
    chars = []
    for c in counts:
        if c == 0:
            chars.append("-")
        elif c <= 9:
            chars.append(str(int(c)))
        else:
            chars.append("*")
    cov = "".join(chars)
    touched = int((counts > 0).sum())
    n = int(np.triu(r.mask, k=1).sum())
    return f"{cov} [{n} restraints touching {touched} residues]"


def parse_tbl_rows(path: str | os.PathLike):
    """Parse a CNS NOE tbl into [(group_i, group_j, d, negdev, posdev)] where
    each group is a list of (resid, atom_name) — including the `or`-group
    layouts the reference's assessor tolerates (ssnoe_tbl_min_pdb_dist,
    chromosome3D.pl:487-554):

        assign (resid I and name A) (resid J and name B) d neg pos
        assign ((resid I and name A) or (resid I and name C)) (...) d neg pos
    """
    import re as _re

    rows = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line.startswith("assign"):
                continue
            if "(" not in line:
                # paren-less layout (`assign45 resid I and name ca resid J
                # and name ca d nd pd`) — CNS tolerates it and the old
                # fixed-index parser accepted it; the group scanner below
                # would swallow the second selection, so handle it here.
                # The numeric tail is taken ONLY from text after the second
                # selection (resid numbers must not leak into d/neg/pos).
                sels = list(_re.finditer(
                    r"resid\s+(\d+)(?:\s+and\s+name\s+(\S+))?", line
                ))
                if len(sels) >= 2:
                    tail_text = line[sels[1].end():]
                    tailm = _re.findall(
                        r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", tail_text
                    )
                    if len(tailm) >= 3:
                        g1 = [(int(sels[0].group(1)),
                               (sels[0].group(2) or "ca").lower())]
                        g2 = [(int(sels[1].group(1)),
                               (sels[1].group(2) or "ca").lower())]
                        d, nd, pd = (float(v) for v in tailm[:3])
                        rows.append((g1, g2, d, nd, pd))
                continue
            c = line.replace("(", " ( ").replace(")", " ) ").split()
            groups: List[List[Tuple[int, str]]] = []
            current: List[Tuple[int, str]] = []
            i = 0
            depth = 0
            tail: List[float] = []
            while i < len(c):
                tok = c[i]
                if tok == "(":
                    depth += 1
                elif tok == ")":
                    depth -= 1
                    if depth == 0:
                        groups.append(current)
                        current = []
                elif tok == "resid":
                    resid = int(c[i + 1])
                    # find the matching "name X" within this atom selection
                    j = i + 2
                    aname = "ca"
                    while j < len(c) and c[j] not in (")", "or"):
                        if c[j] == "name":
                            aname = c[j + 1].lower()
                        j += 1
                    current.append((resid, aname))
                    i = j - 1
                elif depth == 0 and tok not in ("assign", "assign45", "or"):
                    try:
                        tail.append(float(tok))
                    except ValueError:
                        pass
                i += 1
            if len(groups) >= 2 and len(tail) >= 3:
                rows.append((groups[0], groups[1], tail[0], tail[1], tail[2]))
    return rows


def min_group_distance(coords: np.ndarray, g1, g2) -> float:
    """Minimum distance over the atom-group cross product (ref :487-554).
    For CA-bead models every atom name resolves to the residue's bead."""
    best = np.inf
    for r1, _ in g1:
        for r2, _ in g2:
            d = float(np.linalg.norm(coords[r1 - 1] - coords[r2 - 1]))
            best = min(best, d)
    return best


def tbl_row_distances(coords: np.ndarray, rows) -> np.ndarray:
    """Per-tbl-row model distance: ONE vectorized gather covers all
    single-pair rows (the overwhelming majority of any real file); only
    or-group rows take the Python cross-product loop. Measured on this
    machine at R = 10^6 synthetic single-pair rows: ~0.6 s vs ~3.6 s for
    the per-row min_group_distance loop it replaced (~6x; the residual
    cost is the unavoidable per-row categorization scan -- the numpy math
    itself is ~0.05 s)."""
    coords = np.asarray(coords, dtype=np.float64)
    pd_ = np.empty(len(rows), np.float64)
    # flat-list comprehensions + per-list np.asarray: measured 3x faster
    # than building one (k, i, j)-tuple list (np.asarray on a list of
    # tuples is itself the bottleneck at 10^6 rows)
    is_single = [len(r[0]) == 1 and len(r[1]) == 1 for r in rows]
    if all(is_single):
        si = np.asarray([r[0][0][0] for r in rows], dtype=np.int64)
        sj = np.asarray([r[1][0][0] for r in rows], dtype=np.int64)
        diff = coords[si - 1] - coords[sj - 1]
        pd_[:] = np.sqrt((diff * diff).sum(-1))
        return pd_
    sidx = np.asarray(
        [k for k, s in enumerate(is_single) if s], dtype=np.int64
    )
    for k, s in enumerate(is_single):
        if not s:
            pd_[k] = min_group_distance(coords, rows[k][0], rows[k][1])
    if len(sidx):
        si = np.asarray([rows[k][0][0][0] for k in sidx], dtype=np.int64)
        sj = np.asarray([rows[k][1][0][0] for k in sidx], dtype=np.int64)
        diff = coords[si - 1] - coords[sj - 1]
        pd_[sidx] = np.sqrt((diff * diff).sum(-1))
    return pd_


def assess_pdb_vs_tbl(
    coords: np.ndarray, tbl_path: str | os.PathLike, cfg: PipelineConfig
) -> Tuple[int, int, float]:
    """count_satisfied_tbl_rows + sum_noe_dev semantics against an arbitrary
    tbl file (incl. or-groups). Returns (satisfied, total, sum_dev)."""
    coords = np.asarray(coords, dtype=np.float64)
    rows = parse_tbl_rows(tbl_path)
    pd_ = tbl_row_distances(coords, rows)
    dt = np.asarray([r[2] for r in rows], np.float64)
    lo = dt - np.asarray([r[3] for r in rows], np.float64)
    hi = dt + np.asarray([r[4] for r in rows], np.float64)
    satisfied = int((pd_ < hi + cfg.dist_relax).sum()) - int(
        (pd_ < lo - cfg.dist_relax).sum()
    )
    over = pd_ > hi + cfg.sum_dev_margin
    under = pd_ < lo - cfg.sum_dev_margin
    sum_dev = float(((pd_ - hi) * over).sum() + ((lo - pd_) * under).sum())
    return satisfied, len(rows), sum_dev


def violation_coverage_string(
    coords: np.ndarray, r: Restraints, cfg: PipelineConfig
) -> str:
    """Per-bead violation map (ref noe_tbl_violation_coverage :556-579):
    'x' where the bead participates in a violated restraint, '-' otherwise."""
    coords = np.asarray(coords, dtype=np.float64)
    ii, jj = np.nonzero(np.triu(r.mask, k=1))
    diff = coords[ii] - coords[jj]
    d = np.sqrt((diff * diff).sum(-1))
    lo = (r.target[ii, jj] - r.negdev[ii, jj]).astype(np.float64)
    hi = (r.target[ii, jj] + r.posdev[ii, jj]).astype(np.float64)
    viol = ~((lo - cfg.dist_relax <= d) & (d < hi + cfg.dist_relax))
    flags = np.zeros(r.length, dtype=bool)
    flags[ii[viol]] = True
    flags[jj[viol]] = True
    return "".join("x" if f else "-" for f in flags)
