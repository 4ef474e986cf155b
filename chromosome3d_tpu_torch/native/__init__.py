"""Native (C++) host paths — the port's copy of chromosome3d_tpu/native/.

Parsing large whitespace IF matrices and writing the text artifacts (CA-bead
PDBs, `$ID.dist`, `$ID.rr`, `contact.tbl`) get a C++ fast path, loaded with
ctypes. `c3d_native.cc` is a byte copy of the JAX package's source; the
functions below are copies of its loader's, and their output is byte-equal
to the pure-Python branches of io.matrix, io.pdb and restraints.

The library is built at first use by g++ from this package's own copy of the
source, with the JAX package's Makefile flags, into
`chromosome3d_tpu_torch/_build/` under a name keyed by a hash of the source
and the flags (`library_path`): under a file lock, so that two processes
sharing the directory build it once, and published with os.replace, so
that a concurrent loader sees the whole file or none. Where it cannot be
built or loaded (no g++, a failed build, a read-only checkout), every
function returns its "absent" value, the callers take their pure-Python
branches (the same bytes), and the reason is logged once at INFO.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from chromosome3d_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

SOURCE = Path(__file__).resolve().parent / "c3d_native.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# chromosome3d_tpu/native/Makefile's CXXFLAGS, then its -shared
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_LIB = None
_TRIED = False
_LOAD_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libc3d_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library (once per source hash) and return its path;
    RuntimeError when g++ is missing or fails."""
    so = library_path()
    if so.is_file():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if so.is_file():                   # built by another process meanwhile
            return so
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            tmp = os.path.join(work, so.name)
            p = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                               capture_output=True, text=True)
            if p.returncode != 0:
                raise RuntimeError(f"g++ failed ({p.returncode}): {p.stderr.strip()}")
            os.replace(tmp, so)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and result types (an
    AttributeError names a missing symbol)."""
    lib.c3d_parse_matrix.restype = ctypes.c_longlong
    lib.c3d_parse_matrix.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong,
    ]
    lib.c3d_matrix_dims.restype = ctypes.c_longlong
    lib.c3d_matrix_dims.argtypes = [ctypes.c_char_p]
    lib.c3d_write_ca_pdb_v2.restype = ctypes.c_int32
    lib.c3d_write_ca_pdb_v2.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int32,
    ]
    lib.c3d_write_dist.restype = ctypes.c_int32
    lib.c3d_write_dist.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong,
    ]
    lib.c3d_write_rr_rows.restype = ctypes.c_int32
    lib.c3d_write_rr_rows.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong,
    ]
    lib.c3d_rr_to_tbl.restype = ctypes.c_longlong
    lib.c3d_rr_to_tbl.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_double,
        ctypes.c_double,
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded on the first call (by one thread; the
    others wait for it), or None, with the reason logged once."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:
        if not _TRIED:
            try:
                _LIB = _bind(ctypes.CDLL(str(build())))
            except (OSError, AttributeError, RuntimeError) as e:
                _LIB = None
                log.info(f"native library unavailable, the pure-Python branches "
                         f"run instead (the same bytes): {e}")
            _TRIED = True
    return _LIB


def available() -> bool:
    return _load() is not None


def parse_matrix(path: str) -> Optional[np.ndarray]:
    """Parse a whitespace-float matrix file; None if the native lib is absent
    or the file is not a well-formed square grid of numeric tokens with
    uniform row widths (caller falls back to Python, which applies the same
    acceptance rule and raises the descriptive error — so behavior is
    identical with or without the .so built)."""
    lib = _load()
    if lib is None:
        return None
    side = lib.c3d_matrix_dims(path.encode())
    if side <= 0:
        return None
    n = side * side
    buf = np.empty(n, dtype=np.float64)
    got = lib.c3d_parse_matrix(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n
    )
    if got != side:
        return None
    return buf.reshape(side, side)


def write_ca_pdb(
    path: str,
    coords: np.ndarray,
    header: str = "",
    resname: str = "MET",
    connect: bool = True,
) -> bool:
    """Native CA-bead PDB emission (byte-identical to io.pdb.write_ca_pdb;
    parity-tested). header: pre-formatted REMARK lines incl. trailing
    newlines. Returns False when the library is absent or the write failed —
    the caller falls back to the Python writer."""
    lib = _load()
    if lib is None:
        return False
    xyz = np.ascontiguousarray(coords, dtype=np.float64)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        return False
    rc = lib.c3d_write_ca_pdb_v2(
        str(path).encode(),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        xyz.shape[0],
        header.encode(),
        resname.encode(),
        1 if connect else 0,
    )
    return rc == 0


def write_dist(path: str, dist: np.ndarray) -> bool:
    """Native `$ID.dist` emission ("%.1f " cells; byte-parity-tested).
    False = library absent/failed; caller falls back to Python."""
    lib = _load()
    if lib is None:
        return False
    m = np.ascontiguousarray(dist, dtype=np.float64)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        return False
    rc = lib.c3d_write_dist(
        str(path).encode(),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        m.shape[0],
    )
    return rc == 0


def write_rr_rows(path: str, ii: np.ndarray, jj: np.ndarray,
                  dd: np.ndarray) -> bool:
    """Native `$ID.rr` row emission for PRE-ORDERED (i, j, d) arrays
    ('i j %.2f %.2f 1.0'; byte-parity-tested)."""
    lib = _load()
    if lib is None:
        return False
    i32 = np.ascontiguousarray(ii, dtype=np.int32)
    j32 = np.ascontiguousarray(jj, dtype=np.int32)
    d64 = np.ascontiguousarray(dd, dtype=np.float64)
    if not (len(i32) == len(j32) == len(d64)):
        return False
    rc = lib.c3d_write_rr_rows(
        str(path).encode(),
        i32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        j32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        d64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(d64),
    )
    return rc == 0


def rr_to_tbl(rr_path: str, tbl_path: str, zero_d: float,
              zero_neg: float):
    """Native carr2tbl (incl. the literal lo=='0' string special case).
    Returns the row count, or None when the library is absent/failed."""
    lib = _load()
    if lib is None:
        return None
    n = lib.c3d_rr_to_tbl(
        str(rr_path).encode(), str(tbl_path).encode(),
        float(zero_d), float(zero_neg),
    )
    return None if n < 0 else int(n)
