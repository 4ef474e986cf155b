"""Hi-C interaction-frequency matrix I/O — the port's copy of
chromosome3d_tpu/io/matrix.py: the text parse and the `.dist` writer take
the native C++ path (chromosome3d_tpu_torch.native) where its library
builds, and the pure-Python branches, with the same values and bytes,
where it does not.

The reference's loader (`calc_len_IF` + the read loop of `IF2dist_new`,
chromosome3D.pl:110-179) tolerates CRLF line endings, leading whitespace and
trailing separators, and infers L from the field count of the first row.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from chromosome3d_tpu_torch import native


def matrix_length(path: str | os.PathLike) -> int:
    """L = number of whitespace-separated fields of the first row
    (ref: calc_len_IF, chromosome3D.pl:164-179). For binary .npy inputs
    (the at-scale format): the stored shape."""
    if os.fspath(path).endswith(".npy"):
        m = np.load(os.fspath(path), mmap_mode="r")
        if m.ndim != 2:
            raise ValueError(f"{path}: matrix is {m.shape}, expected square")
        return int(m.shape[1])
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                # blank/CRLF-only lines: the same tolerance as
                # load_if_matrix, which skips them — a pre-check must
                # never reject a file the loader accepts
                continue
            return len(line.split())
    raise ValueError(f"{path}: empty matrix file")


def load_if_matrix(path: str | os.PathLike, dtype=np.float64) -> np.ndarray:
    """Load an L x L dense IF matrix.

    Handles the reference input quirks: CRLF endings, leading/trailing
    whitespace, rows as whitespace-separated floats. Returns shape (L, L).

    `.npy` files load as a read-only memmap in their stored dtype (the
    `dtype` argument does not apply): the at-scale input format, which the
    device prep uploads without a text parse. Validation runs in row strips
    of 4096 so the check never holds a second copy of the matrix.
    """
    if os.fspath(path).endswith(".npy"):
        mat = np.load(os.fspath(path), mmap_mode="r")
        if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
            raise ValueError(f"{path}: matrix is {mat.shape}, expected square")
        if not np.issubdtype(mat.dtype, np.floating):
            raise ValueError(f"{path}: dtype {mat.dtype}, expected float")
        for r0 in range(0, mat.shape[0], 4096):
            _validate(mat[r0:r0 + 4096], path)
        return mat

    mat = native.parse_matrix(os.fspath(path))
    if mat is not None:
        return _validate(np.asarray(mat, dtype=dtype), path)

    rows = []
    width: Optional[int] = None
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            fields = line.split()
            if width is None:
                width = len(fields)
            if len(fields) != width:
                raise ValueError(
                    f"{path}: ragged row {len(rows)}: {len(fields)} fields, expected {width}"
                )
            rows.append(fields)
    if not rows:
        raise ValueError(f"{path}: empty matrix file")
    mat = np.asarray(rows, dtype=dtype)
    if mat.shape[0] != mat.shape[1]:
        raise ValueError(f"{path}: matrix is {mat.shape}, expected square")
    return _validate(mat, path)


def _validate(mat: np.ndarray, path) -> np.ndarray:
    """IF matrices are interaction counts/frequencies: finite and
    non-negative. Catch corrupt inputs here rather than as NaN structures
    three subsystems later (the reference dies mid-CNS instead)."""
    if not np.isfinite(mat).all():
        bad = np.argwhere(~np.isfinite(mat))[0]
        raise ValueError(f"{path}: non-finite IF value at {tuple(bad)}")
    if (mat < 0).any():
        bad = np.argwhere(mat < 0)[0]
        raise ValueError(f"{path}: negative IF value at {tuple(bad)}")
    return mat


def write_if_matrix(path: str | os.PathLike, m: np.ndarray) -> None:
    """Write a dense IF matrix in the reference's text format (whitespace
    floats, one row per line)."""
    m = np.asarray(m)
    with open(path, "w") as f:
        for row in m:
            f.write(" ".join(f"{v:.6g}" for v in row))
            f.write("\n")


def write_dist_matrix(path: str | os.PathLike, dist: np.ndarray) -> None:
    """Write the `$ID.dist` artifact: L x L of '%.1f ' cells, one row per line,
    -1 sentinel already applied by the caller (ref: chromosome3D.pl:156-161)."""
    dist = np.asarray(dist)
    # native single-pass emitter when built (byte-identical; the per-cell
    # f-string loop costs minutes at L ~ 10^3-10^4)
    if native.write_dist(path, dist):
        return
    with open(path, "w") as f:
        for row in dist:
            f.write("".join(f"{v:.1f} " for v in row))
            f.write("\n")
