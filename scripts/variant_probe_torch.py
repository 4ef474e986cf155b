"""Kernels B4, B2/B2', B3 and B6 against the other designs kept beside them
in scripts/probe_variants/, on an NVIDIA GPU: device time a call and how far
each variant's outputs are from the shipped kernel's on the same inputs.

    python3 scripts/variant_probe_torch.py [--calls 50] [--only tri]

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

B3 and B6 (tri_pair_variants.cu: the tile-pair body's designs, each a whole
call with the shipped reduce or assembly): B3 at L = 5120 with B = 20 and
10 on chip_smoke.py's at-scale tiles, B6 at the 100 kb genome's buckets of
6 chromosomes of 2048 and 8 of 1536 beads (one strip of Lb = L each, the
at-scale tiles' leading block), B = 20 and 10 a chromosome; milliseconds a
call by CUDA events over --calls calls after a warm call, each variant's
outputs against the shipped call's. Before the times, each pair kernel's
registers, spills and resident blocks an SM at B = 20 and every SASS loop's
instructions per MUFU.RSQ (kernel_resources_torch.py's readers on the
variants' library; --sass FILE keeps its SASS); after each B3 line, the
swapped body's SM cycles a block by phase (its C3D_TRI_TIMING build).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
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
from chromosome3d_tpu_torch.ops.strip_tri import strip_plan, strip_tri_energy_grad  # noqa: E402
from chromosome3d_tpu_torch.ops.tri_energy import tri_energy_grad, tri_plan  # noqa: E402
from kernel_resources_torch import (  # noqa: E402
    demangle,
    ptxas_info,
    resident_blocks,
    sass_loops,
    tool,
)
from step_probe_torch import kernel_times  # noqa: E402

VARIANTS = os.path.join(HERE, "probe_variants")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# xT, gT, muT, nuT, bm, e_pair, table, step, hist, ticket, xTo, muTo, nuTo,
# B, L, first, rows, hist_stride, b1, b2, eps, bond_w, bond_len, clip, seed,
# stream
_B4_ARGS = (_P,) * 13 + (_I,) * 5 + (_F,) * 6 + (_I, _P)
# xT, t, w, bm, gT, e, e_part, ticket, B, L, row0, Lb, noe, vdw, r0, stream
_B2_ARGS = (_P,) * 8 + (_I,) * 4 + (_F,) * 3 + (_P,)
# variant, strip, xT, t, w, bm, part, e_part, gT, e, C, n, L, row0, Lb, noe,
# vdw, r0, stream
_TRI_ARGS = (_I, _I) + (_P,) * 8 + (_I,) * 5 + (_F,) * 3 + (_P,)
TRI_VARIANTS = ("regs 4x4", "smem 4x4", "staged 8x4", "staged 8x8", "staged 8x8 uniform vdw",
                "staged 8x8 j unrolled", "swapped 4x4")
_TRI_SLICE_MAX = (10, 4, 14, 20, 20, 20, 10)   # kSliceMax in tri_pair_variants.cu
# (label, file, C entry, argument types, nvcc -D flags) of each variant
ENTRIES = [
    ("ticket", "fused_update_ticket.cu", "c3d_fused_update_ticket", _B4_ARGS, ()),
    ("eblock", "fused_update_eblock.cu", "c3d_fused_update_eblock", _B4_ARGS, ()),
    ("coord", "fused_update_coord.cu", "c3d_fused_update_coord", _B4_ARGS, ()),
    ("coord 6 blocks an SM", "fused_update_coord.cu", "c3d_fused_update_coord", _B4_ARGS,
     ("-DC3D_MINB=6",)),
    ("staged", "exact_pair_staged.cu", "c3d_exact_pair_staged", _B2_ARGS, ()),
    ("tri", "tri_pair_variants.cu", "c3d_tri_probe", _TRI_ARGS, ("-DC3D_TRI_TIMING",)),
]


def build_variants(out_dir: str, only=None, sass_out=None):
    """({label: ctypes function}, {label: library}) for every variant (or
    those labelled in `only`), all compiled at once; the tri variants'
    resources printed and their SASS written to sass_out, where given."""
    nvcc = _build._nvcc()
    procs = []
    for n, (label, name, entry, argtypes, defines) in enumerate(ENTRIES):
        if only and label not in only:
            continue
        so = os.path.join(out_dir, f"v{n}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, *defines, "-Xptxas", "-v", "-I", str(_build.CSRC),
               "-shared", "-o", so, os.path.join(VARIANTS, name)]
        procs.append((label, entry, argtypes, so,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)))
    fns, libs = {}, {}
    for label, entry, argtypes, so, p in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}:\n{out}\n{err}")
        used = [ln.strip() for ln in err.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {label}: {' | '.join(used)}")
        if label == "tri":
            tri_resources(so, err, sass_out)
        lib = ctypes.CDLL(so)
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[label] = fn
        libs[label] = lib
    return fns, libs


def tri_resources(so: str, ptxas_err: str, sass_out=None) -> None:
    """Each tile-pair kernel of the variants' library: registers, spills,
    resident blocks an SM at its B = 20 shared memory, its loops' SASS
    (the whole SASS written to --sass, where given)."""
    info = ptxas_info(ptxas_err)
    sass = subprocess.run([tool("cuobjdump"), "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    if sass_out:
        os.makedirs(os.path.dirname(os.path.abspath(sass_out)), exist_ok=True)
        with open(sass_out, "w") as f:
            f.write(sass)
    loops = sass_loops(sass)
    names = demangle(list(info))
    for mangled, r in info.items():
        nice = re.split(r"\((?:const float|float)", names[mangled])[0]
        m = re.search(r"probe_pairsILi(\d)E", mangled)
        if m:
            v = int(m.group(1))
            label = TRI_VARIANTS[v]
            bs = -(-20 // -(-20 // _TRI_SLICE_MAX[v]))
            floats = {0: 2512 * bs, 1: 12288 + 2512 * bs, 2: 12288 + 1168 * bs,
                      6: 2512 * bs}.get(
                v, 12288 + 776 * bs)
            smem = 4 * floats + r["smem"]
        elif "tri_pair_kernelILi64" in mangled:
            label, smem = "shipped", tri_plan(20, 5120, 5120, 64)["smem_bytes"] + r["smem"]
        else:
            continue
        blocks = resident_blocks(r["regs"], 256, smem)
        print(f"[resources] {label} ({nice}): {r.get('regs')} registers, spill "
              f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes, {smem} bytes smem at "
              f"B = 20: {blocks} resident blocks an SM")
        for lp in loops.get(mangled, {}).get("loops", []):
            if lp["MUFU.RSQ"]:
                print(f"    loop {lp['from']:#06x}-{lp['to']:#06x}: {lp['instructions']} "
                      f"instructions, {lp['instructions'] / lp['MUFU.RSQ']:.2f} per MUFU.RSQ; "
                      + ", ".join(f"{op} {lp[op]}" for op in ("LDS", "SHFL", "STS", "STG", "BAR")))


def event_ms(fn, calls: int) -> float:
    """Device milliseconds a call by CUDA events over `calls` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


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


def probe_tri(fns, libs, dev, calls: int) -> None:
    _, _, ex, bm_b, xT_b, _, _ = chip_smoke.at_scale_inputs(dev)
    w = _final_weights(AnnealConfig())
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = fns["tri"]
    cases = [("B3", 1, 5120, B) for B in (20, 10)]
    cases += [("B6", C, L, B) for C, L in ((6, 2048), (8, 1536)) for B in (20, 10)]
    for tag, C, L, B in cases:
        if tag == "B3":
            t, wt, bm, xT = ex.target, ex.w, bm_b, xT_b[:B].contiguous()
            plan = tri_plan(B, L, L, 64)

            def shipped():
                return tri_energy_grad(xT, t, wt, w, bm)
        else:
            t = ex.target[:L, :L].contiguous().expand(C, L, L).contiguous()
            wt = ex.w[:L, :L].contiguous().expand(C, L, L).contiguous()
            bm = bm_b[:L].expand(C, L).contiguous()
            xT = xT_b[:B, :, :L].repeat(C, 1, 1).contiguous()
            plan = strip_plan(B, L, L, 0)

            def shipped():
                return strip_tri_energy_grad(xT, t, wt, w, bm, 0)
        e_ref, g_ref = shipped()
        part = torch.empty((C * B, *plan["part_shape"][1:]), device=dev)
        e_part = torch.empty((C * B, plan["e_part_shape"][1]), device=dev)
        gT, e = torch.empty_like(xT), torch.empty(C * B, device=dev)
        line = [f"{tag} {C} x {L}, B = {B} | shipped {event_ms(shipped, calls):.4f}"]
        for v, label in enumerate(TRI_VARIANTS):
            def variant(v=v):
                check(fn(v, int(tag == "B6"), xT.data_ptr(), t.data_ptr(), wt.data_ptr(),
                         bm.data_ptr(), part.data_ptr(), e_part.data_ptr(), gT.data_ptr(),
                         e.data_ptr(), C, B, L, 0, L, w.noe, w.vdw, w.vdw_radius, stream),
                      label)
            variant()
            torch.cuda.synchronize()
            dg = ((gT - g_ref).abs().max() / g_ref.abs().max()).item()
            de = ((e - e_ref).abs() / e_ref.abs()).max().item()
            line.append(f"{label} {event_ms(variant, calls):.4f} (gradient max abs diff / max "
                        f"{dg:.3g}, energy rel diff {de:.3g}, bitwise "
                        f"{torch.equal(gT, g_ref) and torch.equal(e, e_ref)})")
        line.append(f"shipped again {event_ms(shipped, calls):.4f}")
        print(" | ".join(line), flush=True)
        if tag == "B3":
            clock_split(libs["tri"], e_part.shape[1], B)


def clock_split(lib, nblk: int, B: int) -> None:
    """The swapped body's SM cycles by phase in its last launch (thread 0 of
    each block, tri_pair.cuh's C3D_TRI_TIMING), averaged over the blocks."""
    fn = lib.c3d_tri_timing_read
    fn.argtypes = [_P]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * (4096 * 4))()
    check(fn(ctypes.addressof(out)), "c3d_tri_timing_read")
    c = [sum(out[4 * b + i] for b in range(nblk)) / nblk for i in range(4)]
    print(f"    swapped 4x4 at B = {B}, SM cycles a block (mean of {nblk}): prologue "
          f"{c[0]:.0f}, structure loops {c[1]:.0f}, epilogues {c[2]:.0f}, whole {c[3]:.0f}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--only", choices=("tri", "b4", "b2"),
                    help="probe one kernel's variants (default: all)")
    ap.add_argument("--sass", help="write the tri variants' SASS to this file")
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
        only = {"tri": {"tri"}, "b2": {"staged"}, "b4": {"ticket", "eblock", "coord",
                                                         "coord 6 blocks an SM"}}.get(args.only)
        fns, libs = build_variants(work, only, args.sass)
        if args.only in (None, "b4"):
            probe_b4(fns, dev, args.calls)
        if args.only in (None, "b2"):
            probe_b2(fns, dev, args.calls)
        if args.only in (None, "tri"):
            probe_tri(fns, libs, dev, args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
