"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` of this package is compiled, at first use, by nvcc for
Hopper (`sm_90a`) — one nvcc per source, all started together — and the
objects are linked into one shared library with a plain C interface, which
is loaded with ctypes. No PyTorch header is included, so the build takes
seconds (torch.utils.cpp_extension.load, which compiles against PyTorch's
headers, takes minutes). The library lands in `chromosome3d_tpu_torch/_build/`
under a name keyed by a hash of the sources, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source or header rebuilds and an
unchanged tree loads the cached file.

Each C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` raises when that is not 0 (a refused launch
never runs and a later synchronize would not report it). The exact pair
bodies (B1, B2/B2', B3, B6) have a second entry point, `<name>_bf16`, for
bfloat16 restraint tiles (`entry`).
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
    "-Xcompiler", "-fPIC",
)

SMEM_MAX = 232_448   # bytes of shared memory a block can opt into on sm_90

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argument types of every C entry point, in declaration order
SIGNATURES = {
    # xT, t, w, bead_mask, gT, e, e_part, ticket, B, L, row0, Lb, n_per, noe,
    # vdw, vdw_radius, stream
    "c3d_exact_pair": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P,
    ),
    # xT, lo, hi, w, bead_masks, part, e_part, e, gT, C, n_per, L, row0, Lb,
    # cps, bslice, noe, vdw, vdw_radius, rswitch, stream
    "c3d_general_pair": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _P,
    ),
    # xT, t, w, bead_masks, part, e_part, gT, e, C, n_per, L, T, tile, bslice,
    # noe, vdw, vdw_radius, stream
    "c3d_exact_tri": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P,
    ),
    # xT, t, w, bead_masks, part, e_part, gT, e, C, n_per, L, row0, Lb, tile,
    # bslice, noe, vdw, vdw_radius, stream
    "c3d_exact_tri_strip": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P,
    ),
    # xT, gT, muT, nuT, bead_masks, seeds, e_pair, table, step, hist, ticket,
    # xTo, muTo, nuTo, B, n_per, L, first, rows, hist_stride, b1, b2, eps,
    # bond_w, bond_len, clip, stream
    "c3d_fused_update": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _F, _F, _P,
    ),
    # xA, xB, mu, nu, t, w, nb, bead_mask, seeds, table row k0, part, hist,
    # B, L, k0, k1, n_per, cpl, rpw, resident, nsgc, nsgb, nrgb, nrg, sg, sp,
    # lx, smem_bytes, b1, b2, eps, bond_w, bond_len, clip, stream
    "c3d_fused_steps": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _F, _F, _P,
    ),
    # cpl, rpw, resident, smem_bytes -> co-resident blocks (< 0: -CUDA error)
    "c3d_fused_steps_slots": (_I, _I, _I, _I),
}
# the exact pair bodies' entry points on bfloat16 tiles (AnnealConfig.pair_bf16):
# the same arguments, t and w (and B1's nb) pointing at bfloat16 elements
for _name in ("c3d_exact_pair", "c3d_exact_tri", "c3d_exact_tri_strip", "c3d_fused_steps"):
    SIGNATURES[_name + "_bf16"] = SIGNATURES[_name]


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
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libc3d_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Start every command at once and wait for all; raise with the first
    failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}\n{err}"
            )


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernels' library."""
    so = library_path()
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            objs = [os.path.join(work, f"{src.stem}.o") for src in _sources()]
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                      for src, obj in zip(_sources(), objs)])
            tmp = os.path.join(work, so.name)
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
            os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.c3d_error_string.argtypes = [ctypes.c_int]
    lib.c3d_error_string.restype = ctypes.c_char_p
    return lib


_WORKSPACE = {}


def workspace(device, name: str, n: int, dtype=None):
    """At least n elements (int32 by default) of scratch on `device` for
    kernel `name`, made zero once and then kept, so a launch allocates
    nothing. A kernel that counts its arriving blocks in such counters (the
    last to arrive does the launch's final sums) sets them back to 0 before
    it ends. A longer request replaces the buffer with fresh zeros. One
    stream a device uses them, so launches never overlap."""
    import torch

    dtype = torch.int32 if dtype is None else dtype
    key = (str(torch.device(device)), name)
    buf = _WORKSPACE.get(key)
    if buf is None or buf.numel() < n or buf.dtype != dtype:
        buf = _WORKSPACE[key] = torch.zeros(max(n, 64), dtype=dtype, device=device)
    return buf


def entry(lib, name: str, tile_dtype):
    """The C entry point `name` for tiles of tile_dtype: `name` for
    float32, `name`_bf16 for bfloat16 (the wrappers' check_inputs admits
    no other type)."""
    import torch

    return getattr(lib, name + "_bf16" if tile_dtype == torch.bfloat16 else name)


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        text = load_library().c3d_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({text})")
