"""What a persistent multi-step kernel pays per step on the card, and what
kernel B1 takes per step today.

    python3 scripts/fused_steps_probe_torch.py [--blocks 128] [--steps 2000]

Needs nvcc and one NVIDIA GPU. Four measurements, each printed beside the
card's `nvidia-smi` name and power limit:

1. A probe library (the CUDA source below, built with the package's nvcc
   flags, plain C interface) launches a 256-thread kernel on `--blocks`
   co-resident blocks with cudaLaunchCooperativeKernel and loops `--steps`
   times over (a) nothing, (b) cooperative groups' grid.sync(), (c) a
   hand-written barrier on a device counter (one atomic add and a volatile
   spin by thread 0 between two __syncthreads, with __threadfence on both
   sides), (d) that barrier plus what a step of the fused-steps kernel does
   around it: every block writes 60 floats of a (B, 3, L) state and then
   reads the whole state (B = 5 structures of L = 512) back from L2 into
   shared memory, each load stored before the next is issued, (e) grid.sync()
   with the same traffic and all of a thread's loads issued before its first
   store. Device time per loop turn = (time at `--steps` - time at
   0 steps) / steps, from CUDA events. Also the time of an empty kernel
   launched back to back.
2. Kernel B1's single-step entry (`fused_step_batched`) at the reference
   shapes (L = 512; B = 20 and B = 10): device ms per step from
   torch.profiler and ms per step of 500 back-to-back calls between two
   CUDA events (the rate the host can issue them at).
3. The multi-step entry (`fused_steps_batched`) at the same shapes: device
   ms per step of one 256-step launch and of one 1-step launch.
4. With --parts: csrc/fused_steps.cu built once more with -DC3D_STEPS_TIMING
   into a library of its own; thread 0 of every block counts the SM cycles
   of each part of a step (staging, sweep and fold, update, waiting for the
   block, energies, grid barrier) over a 256-step launch; printed per step
   as the mean and the largest over the blocks, in us at the SM clock that
   nvidia-smi reports under the launch.
5. With --modes: the multi-step entry at the lengths past 512 that the
   24-column resident variants serve (L = 640 and 768; B = 20 and 10), once
   under the plan as it stands and once with those variants taken out of the
   plan, so that the streamed variant runs: device ms per step of one
   256-step launch, and whether the two modes give equal bits (they need
   not: a lane's columns, and so the order of its sums, differ).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chromosome3d_tpu_torch.ops import _build  # noqa: E402

PROBE_CU = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ void hand_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*((volatile unsigned*)counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// mode 0: empty loop; 1: grid.sync(); 2: hand barrier; 3: hand barrier with
// a step's state traffic (write 60 floats, read 5 x 3 x 512 back to smem,
// each load stored before the next is issued); 4: grid.sync() with the same
// traffic, all 30 loads of a thread issued before the first store
__global__ void __launch_bounds__(256, 1)
probe_kernel(unsigned* counter, float* state, float* sink, int steps, int mode) {
  __shared__ float4 xs[5 * 512];
  cg::grid_group grid = cg::this_grid();
  float acc = 0.f;
  for (int k = 0; k < steps; ++k) {
    if (mode >= 3) {
      float* out = state + (size_t)((k + 1) & 1) * 5 * 3 * 512;
      const float* in = state + (size_t)(k & 1) * 5 * 3 * 512;
      if (mode == 3) {
        for (int s = 0; s < 5; ++s)
          for (int c = 0; c < 3; ++c)
            for (int j = threadIdx.x; j < 512; j += 256)
              ((float*)&xs[s * 512 + j])[c] = __ldcg(in + (s * 3 + c) * 512 + j);
      } else {
        float buf[15][2];
#pragma unroll
        for (int q = 0; q < 15; ++q)
#pragma unroll
          for (int u = 0; u < 2; ++u) buf[q][u] = __ldcg(in + q * 512 + threadIdx.x + 256 * u);
#pragma unroll
        for (int q = 0; q < 15; ++q)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            ((float*)&xs[(q / 3) * 512 + threadIdx.x + 256 * u])[q % 3] = buf[q][u];
      }
      __syncthreads();
      acc += xs[threadIdx.x].x;
      if (threadIdx.x < 60)
        out[(threadIdx.x / 4) * 512 + (blockIdx.x * 4 + (threadIdx.x & 3)) % 512] = acc;
    }
    if (mode == 1 || mode == 4) grid.sync();
    if (mode == 2 || mode == 3) hand_barrier(counter, (unsigned)(k + 1) * gridDim.x);
  }
  if (acc == 123.456f) sink[0] = acc;
}

__global__ void empty_kernel() {}

extern "C" int probe_run(unsigned* counter, float* state, float* sink, int blocks,
                         int steps, int mode, void* stream) {
  cudaMemsetAsync(counter, 0, sizeof(unsigned), (cudaStream_t)stream);
  void* args[] = {&counter, &state, &sink, &steps, &mode};
  return (int)cudaLaunchCooperativeKernel((void*)probe_kernel, dim3(blocks), dim3(256),
                                          args, 0, (cudaStream_t)stream);
}

extern "C" int probe_empty(int blocks, int reps, void* stream) {
  for (int i = 0; i < reps; ++i) empty_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def event_ms(fn, reps: int = 5) -> float:
    """Least device-side milliseconds of fn() between two CUDA events."""
    best = float("inf")
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def profiler_ms(fn, n: int) -> float:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n


def probe_barriers(blocks: int, steps: int) -> None:
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as work:
        src = os.path.join(work, "probe.cu")
        so = os.path.join(work, "libprobe.so")
        with open(src, "w") as f:
            f.write(PROBE_CU)
        cc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, src],
                            capture_output=True, text=True)
        if cc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the probe (no -rdc given):\n{cc.stderr}")
        print("[probe] built without -rdc=true: cooperative groups' grid.sync() compiles "
              "in one translation unit")
        lib = ctypes.CDLL(so)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.probe_run.argtypes = [P, P, P, I, I, I, P]
        lib.probe_empty.argtypes = [I, I, P]
        counter = torch.zeros(4, dtype=torch.int32, device=dev)
        state = torch.zeros(2 * 5 * 3 * 512, device=dev)
        sink = torch.zeros(4, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run(n, mode):
            err = lib.probe_run(counter.data_ptr(), state.data_ptr(), sink.data_ptr(),
                                blocks, n, mode, stream)
            if err:
                raise RuntimeError(f"probe_run: CUDA error {err}")

        for mode, name in ((0, "empty loop"), (1, "grid.sync()"), (2, "hand barrier"),
                           (3, "hand barrier + a step's state traffic, loads serialised"),
                           (4, "grid.sync() + a step's state traffic, loads batched")):
            run(10, mode)
            base = event_ms(lambda: run(0, mode))
            full = event_ms(lambda: run(steps, mode))
            print(f"[probe] {blocks} blocks x 256 threads, {name}: launch alone "
                  f"{1e3 * base:.3f} us, {steps} turns {1e3 * full:.3f} us, "
                  f"{1e3 * (full - base) / steps:.4f} us a turn")
        lib.probe_empty(blocks, 10, stream)
        ms = event_ms(lambda: lib.probe_empty(blocks, 1000, stream))
        print(f"[probe] empty kernel, {blocks} x 256, 1000 back-to-back launches: "
              f"{ms:.4f} us each")


def step_inputs(B: int, L: int = 512, n_real: int = 456):
    """Exact restraints of a random IF matrix padded to L, and a B-structure
    state with random moments, on the card."""
    from chromosome3d_tpu_torch.config import RestraintConfig
    from chromosome3d_tpu_torch.ops.energy import EnergyWeights, exact_restraints_from_numpy
    from chromosome3d_tpu_torch.ops.fused_step import fused_step_tiles
    from chromosome3d_tpu_torch.restraints import build_restraints

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    base = rng.gamma(2.0, 50.0, size=(n_real, n_real))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    ex = exact_restraints_from_numpy(build_restraints(m, RestraintConfig()).padded(L),
                                     device=dev)
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    to = lambda a: torch.tensor(a.astype(np.float32), device=dev)
    x = to(rng.randn(B, 3, L) * 30 * bead)
    mu = to(rng.normal(0, 0.1, x.shape) * bead)
    nu = to(np.abs(rng.normal(0, 0.01, x.shape)) * bead)
    w = EnergyWeights(noe=10.0, bond=10.0, bond_length=3.8, vdw=4.0,
                      vdw_radius=float(np.float32(3.06)))
    bm = to(bead)
    return fused_step_tiles(ex, bm, w.noe), w, bm, x, mu, nu


def time_single_step() -> None:
    from chromosome3d_tpu_torch.ops.fused_step import fused_step_batched

    for B in (20, 10):
        tiles, w, bm, x, mu, nu = step_inputs(B)
        call = lambda: fused_step_batched(x, mu, nu, tiles, w, bm, 0.05, 0.6, 2.3, 101.0,
                                          12345, 6, 0.5)
        for _ in range(5):
            call()
        dev_ms = profiler_ms(call, 50)
        ev = event_ms(lambda: [call() for _ in range(500)]) / 500
        print(f"[B1 single step] B={B}, L=512: device {dev_ms:.5f} ms a step "
              f"(torch.profiler, 50 calls); 500 back-to-back calls {ev:.5f} ms a step "
              "(CUDA events, host-issue rate)")


def time_multi_step() -> None:
    from chromosome3d_tpu_torch.ops import fused_step

    if not hasattr(fused_step, "fused_steps_batched"):
        print("[B1 multi step] this tree has no fused_steps_batched")
        return
    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch.solver.anneal import schedule_table

    table = schedule_table(AnnealConfig(), seed=12345)
    for B in (20, 10):
        tiles, _, bm, x, mu, nu = step_inputs(B)
        run = lambda k0, k1: fused_step.fused_steps_batched(x, mu, nu, tiles, table, k0,
                                                            k1, bm)
        run(0, 4)
        one = event_ms(lambda: run(300, 301))
        many = event_ms(lambda: run(300, 556))
        print(f"[B1 multi step] B={B}, L=512: one 256-step launch with its clones and "
              f"its history sum {many:.4f} ms = {many / 256:.5f} ms a step; a 1-step "
              f"launch {one:.5f} ms (CUDA events, least of 5)")


def time_modes() -> None:
    """Resident (24 columns a lane) against streamed at 512 < L <= 768."""
    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch.ops import fused_step
    from chromosome3d_tpu_torch.solver.anneal import schedule_table

    table = schedule_table(AnnealConfig(), seed=12345)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    compiled = fused_step._RESIDENT_CPL
    for L, n_real in ((640, 600), (768, 700)):
        for B in (20, 10):
            tiles, _, bm, x, mu, nu = step_inputs(B, L, n_real)
            run = lambda: fused_step.fused_steps_batched(x, mu, nu, tiles, table, 300, 556,
                                                         bm)
            ms, out = {}, {}
            for mode, cpls in (("resident", compiled), ("streamed", compiled[:1])):
                fused_step._RESIDENT_CPL = cpls
                try:
                    plan = fused_step.fused_steps_plan(L, B, n_sm)
                    if plan["mode"] != mode:
                        raise RuntimeError(f"L={L}, B={B}: plan is {plan['mode']}, "
                                           f"wanted {mode}")
                    out[mode] = run()
                    ms[mode] = (event_ms(run) / 256, plan)
                finally:
                    fused_step._RESIDENT_CPL = compiled
            same = all(torch.equal(a, b) for a, b in zip(out["resident"], out["streamed"]))
            print(f"[B1 modes] B={B}, L={L}: ms a step of one 256-step launch (CUDA events, "
                  "least of 5): " + "; ".join(
                      f"{mode} {t:.5f} ({p['blocks']} blocks, {p['cpl']} columns a lane, "
                      f"{p['rpw']} row(s) a warp, {p['sg']} structures a block)"
                      for mode, (t, p) in ms.items())
                  + f"; the two modes' bits equal: {same}")


PARTS = ("staging (with the block's barriers)", "sweep and fold", "update",
         "waiting for the block's warps", "energies", "grid barrier")


def time_parts() -> None:
    """Per-part SM cycles of a step from the -DC3D_STEPS_TIMING build."""
    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch.ops import fused_step
    from chromosome3d_tpu_torch.solver.anneal import schedule_table

    with tempfile.TemporaryDirectory() as work:
        so = os.path.join(work, "libsteps_timing.so")
        cc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DC3D_STEPS_TIMING",
                             "-shared", "-o", so, str(_build.CSRC / "fused_steps.cu")],
                            capture_output=True, text=True)
        if cc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the timing build:\n{cc.stderr}")
        lib = ctypes.CDLL(so)
        for name in ("c3d_fused_steps", "c3d_fused_steps_slots"):
            getattr(lib, name).argtypes = list(_build.SIGNATURES[name])
        lib.c3d_fused_steps_timing.argtypes = [ctypes.c_void_p]
        real = _build.load_library
        _build.load_library = lambda: lib
        try:
            table = schedule_table(AnnealConfig(), seed=12345)
            for B in (20, 10):
                tiles, _, bm, x, mu, nu = step_inputs(B)
                n = 256
                fused_step.fused_steps_batched(x, mu, nu, tiles, table, 300, 300 + n, bm)
                torch.cuda.synchronize()
                ms = event_ms(lambda: fused_step.fused_steps_batched(
                    x, mu, nu, tiles, table, 300, 300 + n, bm))
                clock = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, timeout=60).stdout.split()[0]
                out = np.zeros((256, len(PARTS)), np.int64)
                err = lib.c3d_fused_steps_timing(out.ctypes.data)
                if err:
                    raise RuntimeError(f"c3d_fused_steps_timing: CUDA error {err}")
                blocks = fused_step.fused_steps_plan(512, B)["blocks"]
                us = out[:blocks] / n / float(clock)        # cycles a step / MHz
                print(f"[B1 parts] B={B}, L=512, {n}-step launch {ms / n:.5f} ms a step with "
                      f"the counters in; SM clock {clock} MHz; us a step, mean | max over "
                      f"{blocks} blocks: " + "; ".join(
                          f"{name} {us[:, q].mean():.3f} | {us[:, q].max():.3f}"
                          for q, name in enumerate(PARTS))
                      + f"; sum of means {us.mean(0).sum():.3f}")
        finally:
            _build.load_library = real


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=128)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--parts", action="store_true",
                    help="also time the parts of a step inside the multi-step kernel")
    ap.add_argument("--modes", action="store_true",
                    help="also time resident against streamed at L = 640 and 768")
    ap.add_argument("--only-modes", action="store_true",
                    help="time the modes and nothing else")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fused_steps_probe_torch: needs an NVIDIA GPU")
    print(card())
    if not args.only_modes:
        probe_barriers(args.blocks, args.steps)
        time_single_step()
        time_multi_step()
        if args.parts:
            time_parts()
    if args.modes or args.only_modes:
        time_modes()
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
