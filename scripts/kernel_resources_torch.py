"""Resource usage and inner-loop instruction counts of the port's CUDA kernels.

    python3 scripts/kernel_resources_torch.py [--src DIR] [--out DIR]
        [--launch NAME=THREADS:DYNAMIC_SMEM_BYTES ...] [--clock]

Needs the CUDA toolkit (nvcc, cuobjdump); --clock also needs a card. For
every `*.cu` under --src (default: chromosome3d_tpu_torch/csrc) it compiles
the source with the package's flags plus `-Xptxas -v`, prints ptxas'
registers, spill bytes and static shared memory of each kernel, dumps the
SASS (`cuobjdump -sass`) to --out, and lists every loop of every kernel (a
branch back to an earlier address): its instruction count, its MUFU.RSQ
count (one per pair evaluation in the pair kernels), instructions per
MUFU.RSQ, and its global loads, shared loads, shuffles and barriers.

Resident blocks per SM are computed from the H100's limits (65,536
registers allocated per warp in units of 256, 233,472 bytes of shared
memory with 1,024 reserved per block, 64 warps, 32 blocks) for the launch
shapes given with --launch (NAME is a substring of the kernel's name);
without one, the at-scale shapes of the two pair bodies are taken from the
wrappers' plan functions at B = 20, L = 5120, and the multi-step kernel's
variants get the shared memory of the reference-scale launches (L = 512:
B = 20 then 10) and of L = 768 and a streamed L = 2048 at B = 20.

--clock prints `nvidia-smi --query-gpu=clocks.sm,power.draw` while the
general pair kernel runs back to back at B = 20, L = 5120: the SM clock
under load, for the issue floor
    instructions per pair x pairs / (132 SMs x 128 lanes x clock).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chromosome3d_tpu_torch.ops import _build  # noqa: E402

SM_REGS, SM_SMEM, SM_WARPS, SM_BLOCKS, SMEM_RESERVED = 65536, 233472, 64, 32, 1024
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_COUNTED = ("MUFU.RSQ", "LDG", "LDS", "SHFL", "BAR", "STS", "STG", "LDGSTS")


def tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    cand = Path(_build._nvcc()).parent / name
    if cand.is_file():
        return str(cand)
    raise RuntimeError(f"{name} not found beside nvcc")


def demangle(names):
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if not filt:
        return {n: n for n in names}
    out = subprocess.run([filt, *names], capture_output=True, text=True).stdout.split("\n")
    return dict(zip(names, out))


def ptxas_info(stderr: str):
    """{mangled kernel: {regs, spill_stores, spill_loads, smem}}."""
    info, cur = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = info.setdefault(m.group(1), {"smem": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return info


def sass_loops(sass: str):
    """{mangled kernel: [loop dicts]} from cuobjdump -sass text."""
    out, cur, instrs = {}, None, []

    def close():
        if cur is None:
            return
        loops = []
        for k, (addr, text) in enumerate(instrs):
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
            if not m or int(m.group(1), 16) > addr:
                continue
            start = int(m.group(1), 16)
            body = [t for a, t in instrs[:k + 1] if a >= start]
            loop = {"from": start, "to": addr, "instructions": len(body)}
            opcodes = [t.split()[1] if t.startswith("@") else t.split()[0] for t in body]
            for op in _COUNTED:
                loop[op] = sum(1 for o in opcodes if o == op or o.startswith(op + "."))
            loops.append(loop)
        out[cur] = {"instructions": len(instrs), "loops": loops}

    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            cur, instrs = m.group(1), []
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            instrs.append((int(m.group(1), 16), m.group(2).strip()))
    close()
    return out


def resident_blocks(regs: int, threads: int, smem: int) -> int:
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = (SM_REGS // 4 // per_warp) * 4 // warps if per_warp else SM_BLOCKS
    by_smem = SM_SMEM // (smem + SMEM_RESERVED)
    return max(0, min(by_regs, by_smem, SM_WARPS // warps, SM_BLOCKS))


def default_launches():
    """The two pair bodies at the at-scale shapes and the multi-step kernel's
    variants at the shapes that select them, from the wrappers' plans."""
    from chromosome3d_tpu_torch.ops.fused_step import fused_steps_plan
    from chromosome3d_tpu_torch.ops.general_pair import general_pair_plan
    from chromosome3d_tpu_torch.ops.tri_energy import tri_plan

    g = general_pair_plan(20, 5120, 5120)
    t = tri_plan(20, 5120, 5120, 64)
    out = {"general_pair_kernel": (g["threads"], g["smem_bytes"]),
           "tri_pair_kernelILi64": (t["threads"], t["smem_bytes"])}   # <64>, mangled
    for L, B in ((512, 20), (512, 10), (768, 20), (2048, 20)):
        p = fused_steps_plan(L, B)
        # fused_steps_kernel<cpl, rpw, resident>, mangled
        key = (f"fused_steps_kernelILi{p['cpl']}ELi{p['rpw']}"
               f"ELb{int(p['mode'] == 'resident')}E")
        out[key] = (p["threads"], p["smem_bytes"])
    return out


def clock_under_load():
    import numpy as np
    import torch

    from chromosome3d_tpu_torch.ops.energy import EnergyWeights
    from chromosome3d_tpu_torch.ops.general_pair import general_pair_energy_grad

    dev = torch.device("cuda", 0)
    L, B = 5120, 20
    g = torch.Generator(device="cpu").manual_seed(0)
    x = (torch.randn(B, 3, L, generator=g) * 30).to(dev)
    d = torch.rand(L, L, generator=g) * 50 + 1
    lo, hi = (d * 0.9).to(dev), (d * 1.1).to(dev)
    w = torch.ones(L, L, device=dev)
    bm = torch.ones(L, device=dev)
    weights = EnergyWeights(noe=10.0, bond=10.0, bond_length=3.8, vdw=4.0,
                            vdw_radius=float(np.float32(3.06)))
    for _ in range(3):
        general_pair_energy_grad(x, lo, hi, w, weights, bm)
    torch.cuda.synchronize()
    for rep in range(3):
        for _ in range(1500):
            general_pair_energy_grad(x, lo, hi, w, weights, bm)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        busy = not torch.cuda.current_stream().query()
        print(f"[clock] under load (queue still busy: {busy}): {smi.stdout.strip()}")
        torch.cuda.synchronize()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(_build.CSRC))
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "resources"),
                    help="where the SASS dumps go (default: the build directory)")
    ap.add_argument("--launch", action="append", default=[],
                    help="NAME=THREADS:DYNAMIC_SMEM_BYTES (NAME a substring)")
    ap.add_argument("--clock", action="store_true")
    args = ap.parse_args()

    launches = {}
    for spec in args.launch:
        name, shape = spec.split("=")
        threads, smem = shape.split(":")
        launches[name] = (int(threads), int(smem))
    if not launches:
        launches = default_launches()

    nvcc, cuobjdump = _build._nvcc(), tool("cuobjdump")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as work:
        for src in sorted(Path(args.src).glob("*.cu")):
            obj = os.path.join(work, src.stem + ".o")
            cc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                                 str(src)], capture_output=True, text=True)
            if cc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{cc.stdout}\n{cc.stderr}")
            info = ptxas_info(cc.stderr)
            sass = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                                  text=True, check=True).stdout
            (out / f"{src.stem}.sass").write_text(sass)
            loops = sass_loops(sass)
            names = demangle(list(info))
            for mangled, r in info.items():
                # drop the parameter list (every kernel's first is a float pointer)
                nice = re.split(r"\((?:const float|float)", names[mangled])[0]
                line = (f"[resources] {src.name} {nice}: {r.get('regs')} registers, spill "
                        f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes, static smem "
                        f"{r['smem']} bytes, {loops.get(mangled, {}).get('instructions')} "
                        "SASS instructions")
                for key, (threads, dyn) in launches.items():
                    if key in nice or key in mangled:
                        n = resident_blocks(r["regs"], threads, r["smem"] + dyn)
                        line += (f"; at {threads} threads, {r['smem'] + dyn} bytes smem: "
                                 f"{n} resident blocks an SM ({n * threads // 32} warps)")
                        break
                print(line)
                for lp in loops.get(mangled, {}).get("loops", []):
                    per = (f"{lp['instructions'] / lp['MUFU.RSQ']:.1f} per MUFU.RSQ"
                           if lp["MUFU.RSQ"] else "no MUFU.RSQ")
                    print(f"    loop {lp['from']:#06x}-{lp['to']:#06x}: "
                          f"{lp['instructions']} instructions, {per}; "
                          + ", ".join(f"{op} {lp[op]}" for op in _COUNTED))
    print(f"[resources] SASS written to {out}")
    if args.clock:
        clock_under_load()
    return 0


if __name__ == "__main__":
    sys.exit(main())
