"""Restraints: the JAX package's jax-free host code
(chromosome3d_tpu.restraints, float64 numpy), re-exported so that the
restraint tensors and the `.rr` / `contact.tbl` text artifacts are
byte-identical between the two packages, plus the port's own
`read_contact_tbl_full`: the JAX package's imports its assess module at
call time, which imports jax.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from chromosome3d_tpu.restraints import (
    OrGroups,
    Restraints,
    build_restraints,
    dist_to_restraints,
    if_to_dist,
    read_rr,
    restraints_from_exact_target,
    write_contact_tbl,
    write_rr,
)

__all__ = ["OrGroups", "Restraints", "build_restraints", "dist_to_restraints",
           "if_to_dist", "read_contact_tbl_full", "read_rr",
           "restraints_from_exact_target", "write_contact_tbl", "write_rr"]


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
