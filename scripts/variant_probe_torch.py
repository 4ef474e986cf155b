"""Kernels B4 and B2/B2' against the other designs kept beside them in
scripts/probe_variants/, on an NVIDIA GPU: device time a call and how far
each variant's outputs are from the shipped kernel's on the same inputs.

    python3 scripts/variant_probe_torch.py [--calls 50]

Each scripts/probe_variants/*.cu is compiled on its own (nvcc with the
package's flags and csrc/'s headers, `-Xptxas -v` printed) into a library
with a plain C entry and called through ctypes at the shapes the port's
paths give the kernel — B4 at L = 5120, B = 20 and 10 and at L = 512,
B = 20 (consecutive steps of the default schedule from a device counter);
B2 at L = 512, B = 20; B2' on rows 256..511 of L = 512, B = 20 and 10 —
with chip_smoke.py's inputs. The shipped kernel is called through its
wrapper (B2 through the row-offset face at row 0: the pick's launch
without its transpose). Device microseconds a call are torch.profiler's, over --calls
calls, every kernel of the call counted; the shipped kernel is timed first
and last, so the drift between them is seen. Prints the card's
`nvidia-smi --query-gpu=name,power.limit` line first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from chromosome3d_tpu_torch.config import AnnealConfig  # noqa: E402
from chromosome3d_tpu_torch.ops import _build  # noqa: E402
from chromosome3d_tpu_torch.ops.fused_step import _c_int32  # noqa: E402
from chromosome3d_tpu_torch.ops.fused_update import fused_update_table, step_counter  # noqa: E402
from chromosome3d_tpu_torch.ops.pair_energy import exact_row_block_energy_grad  # noqa: E402
from chromosome3d_tpu_torch.solver.anneal import _final_weights, schedule_table  # noqa: E402
from step_probe_torch import kernel_times  # noqa: E402

VARIANTS = os.path.join(HERE, "probe_variants")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# xT, gT, muT, nuT, bm, e_pair, table, step, hist, ticket, xTo, muTo, nuTo,
# B, L, first, rows, hist_stride, b1, b2, eps, bond_w, bond_len, clip, seed,
# stream
_B4_ARGS = (_P,) * 13 + (_I,) * 5 + (_F,) * 6 + (_I, _P)
# xT, t, w, bm, gT, e, e_part, ticket, B, L, row0, Lb, noe, vdw, r0, stream
_B2_ARGS = (_P,) * 8 + (_I,) * 4 + (_F,) * 3 + (_P,)
# (label, file, C entry, argument types, nvcc -D flags) of each variant
ENTRIES = [
    ("ticket", "fused_update_ticket.cu", "c3d_fused_update_ticket", _B4_ARGS, ()),
    ("eblock", "fused_update_eblock.cu", "c3d_fused_update_eblock", _B4_ARGS, ()),
    ("coord", "fused_update_coord.cu", "c3d_fused_update_coord", _B4_ARGS, ()),
    ("coord 6 blocks an SM", "fused_update_coord.cu", "c3d_fused_update_coord", _B4_ARGS,
     ("-DC3D_MINB=6",)),
    ("staged", "exact_pair_staged.cu", "c3d_exact_pair_staged", _B2_ARGS, ()),
]


def build_variants(out_dir: str):
    """{label: ctypes function} for every variant, all compiled at once."""
    nvcc = _build._nvcc()
    procs = []
    for n, (label, name, entry, argtypes, defines) in enumerate(ENTRIES):
        so = os.path.join(out_dir, f"v{n}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, *defines, "-Xptxas", "-v", "-I", str(_build.CSRC),
               "-shared", "-o", so, os.path.join(VARIANTS, name)]
        procs.append((label, entry, argtypes, so,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)))
    fns = {}
    for label, entry, argtypes, so, p in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}:\n{out}\n{err}")
        used = [ln.strip() for ln in err.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {label}: {' | '.join(used)}")
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def us_a_call(fn, calls: int) -> float:
    times = kernel_times(fn, calls)
    return sum(us for _, us in times.values()) / calls


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def probe_b4(fns, dev, calls: int) -> None:
    _, _, _, bm_s, xT_s, mu_s, nu_s, _ = chip_smoke.slice_inputs(dev)
    _, _, _, bm_b, xT_b, mu_b, nu_b = chip_smoke.at_scale_inputs(dev)
    table = schedule_table(AnnealConfig(), seed=12345)
    rows = table.device_rows(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    for L, bm, xT, mu, nu in ((5120, bm_b, xT_b, mu_b, nu_b), (512, bm_s, xT_s, mu_s, nu_s)):
        for B in ((20, 10) if L == 5120 else (20,)):
            st = [a[:B].contiguous() for a in (xT, mu, nu)]
            g = (0.01 * st[0]).contiguous()
            e_pair = torch.linspace(1.0, 2.0, B, device=dev)
            hist = torch.zeros((len(table.rows), B), device=dev)
            counter = step_counter(0, dev)

            def shipped():
                return fused_update_table(st[0], g, st[1], st[2], e_pair, bm, table,
                                          counter, hist)

            def variant(fn, out, hist_v, counter_v):
                def call():
                    check(fn(st[0].data_ptr(), g.data_ptr(), st[1].data_ptr(),
                             st[2].data_ptr(), bm.data_ptr(), e_pair.data_ptr(),
                             rows.data_ptr(), counter_v.data_ptr(), hist_v.data_ptr(),
                             ticket.data_ptr(), *(a.data_ptr() for a in out), B, L,
                             table.first, len(table.rows), hist_v.stride(0), table.b1,
                             table.b2, table.eps_adam, table.base.bond,
                             table.base.bond_length,
                             -1.0 if table.clip is None else table.clip,
                             _c_int32(table.seed), stream), "variant")
                return call

            # agreement at step 296 (a hot step with noise), then times
            counter.fill_(296)
            ref = shipped()
            line = [f"B4 L={L} B={B} | shipped {us_a_call(shipped, calls):.2f}"]
            for name, fn in fns.items():
                if len(fn.argtypes) != len(_B4_ARGS):
                    continue
                out = [torch.empty_like(st[0]) for _ in range(3)]
                hist_v = torch.zeros_like(hist)
                counter_v = step_counter(296, dev)
                variant(fn, out, hist_v, counter_v)()
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(out, ref))
                dh = ((hist_v[296] - hist[296]).abs().max() / hist[296].abs().max()).item()
                moved = int(counter_v[0]) == 297
                counter_v.fill_(0)
                t = us_a_call(variant(fn, out, hist_v, counter_v), calls)
                line.append(f"{name} {t:.2f} (state bitwise {same}, history "
                            f"row max abs diff / max {dh:.3g}, counter moved {moved})")
            line.append(f"shipped again {us_a_call(shipped, calls):.2f}")
            print(" | ".join(line))


def probe_b2(fns, dev, calls: int) -> None:
    _, _, ex_s, bm_s, xT_s, _, _, _ = chip_smoke.slice_inputs(dev)
    w = _final_weights(AnnealConfig())
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = fns["staged"]
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    for tag, B, row0 in (("B2", 20, 0), ("B2'", 20, 256), ("B2'", 10, 256)):
        xB = xT_s[:B].contiguous()
        t, wt = ex_s.target[row0:].contiguous(), ex_s.w[row0:].contiguous()
        Lb, L = t.shape[0], t.shape[1]
        # B2 through the row-offset face at row 0: the same launch as the
        # pick's, without the transpose its (B, L, 3) face adds

        def shipped():
            return exact_row_block_energy_grad(xB, t, wt, w, bm_s, row0)

        e_ref, g_ref = shipped()
        e = torch.empty(B, device=dev)
        gT = torch.empty((B, 3, Lb), device=dev)
        e_part = torch.zeros(B * -(-Lb // 8), device=dev)   # row groups of 8

        def variant():
            check(fn(xB.data_ptr(), t.data_ptr(), wt.data_ptr(), bm_s.data_ptr(),
                     gT.data_ptr(), e.data_ptr(), e_part.data_ptr(), ticket.data_ptr(),
                     B, L, row0, Lb, w.noe, w.vdw, w.vdw_radius, stream), "staged")

        variant()
        torch.cuda.synchronize()
        dg = ((gT - g_ref).abs().max() / g_ref.abs().max()).item()
        de = ((e - e_ref).abs() / e_ref.abs()).max().item()
        print(f"{tag} Lb={Lb} of L={L} B={B} | shipped {us_a_call(shipped, calls):.2f} | "
              f"staged {us_a_call(variant, calls):.2f} (gradient max abs diff / max "
              f"{dg:.3g}, energy rel diff {de:.3g}) | shipped again "
              f"{us_a_call(shipped, calls):.2f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("variant_probe_torch: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    _build.load_library()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        fns = build_variants(work)
        probe_b4(fns, dev, args.calls)
        probe_b2(fns, dev, args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
