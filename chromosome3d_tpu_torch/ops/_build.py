"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` of this package is compiled, at first use, by nvcc for
Hopper (`sm_90a`) into one shared library with a plain C interface, which
is loaded with ctypes. No PyTorch header is included, so the build takes
seconds (torch.utils.cpp_extension.load, which compiles against PyTorch's
headers, takes minutes). The library lands in `chromosome3d_tpu_torch/_build/`
under a name keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the cached file.

Each C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` raises when that is not 0 (a refused launch
never runs and a later synchronize would not report it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argument types of every C entry point, in declaration order
SIGNATURES = {
    # x, t, w, bead_mask, e_rows, g, B, L, noe, vdw, vdw_radius, stream
    "c3d_exact_pair": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P),
    # xT, muT, nuT, t, w, nb, bead_mask, e_rows, xTo, muTo, nuTo, B, L,
    # vdw, vdw_radius, lr, sigma, b1, b2, eps, bc1, bc2, bond_w, bond_len,
    # clip, seed, step, stream
    "c3d_fused_step": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
        _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _I, _I, _P,
    ),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/*.cu at first use"
    )


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libc3d_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernels' library."""
    so = library_path()
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.c3d_error_string.argtypes = [ctypes.c_int]
    lib.c3d_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        text = load_library().c3d_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({text})")
