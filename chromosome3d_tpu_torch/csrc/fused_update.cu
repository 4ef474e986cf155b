// Kernel B4: the update half of an annealing step, given a pair gradient
// made by another kernel — chain bond, per-bead clip, Adam with the bias
// corrections passed in, CLT-4 Langevin noise and the coordinate move.
//
// Replaces: chromosome3d_tpu/ops/pallas_energy.py `_kernel_fused_update`
// (entry `pallas_fused_update_batched`). On the port's semi route it runs
// every step after kernel B3 (exact_tri.cu) has formed the pair gradient:
// at the at-scale shape B = 20 then 10 structures, L = 5120.
//
// The per-bead math is step_common.cuh's `update_bead`, the very code B1
// runs after its pair sweep, so B4's bond, update and noise bits are B1's
// by construction.
//
// What bounds it on an H100: per bead ~60 FP32 operations, three sqrt and
// ~60 integer operations of noise hashing, and 14 floats of state read or
// written (x with its two neighbours, g, mu, nu in; x', mu', nu' out). At
// B = 20, L = 5120 that is 102,400 beads and ~6 MB of traffic a step: a
// few microseconds of HBM time, so launch latency bounds it. Design: one
// thread per (bead, structure), grid (bead blocks, B); neighbouring threads
// read neighbouring beads of the (3, L) layout, so every access is
// coalesced. Outputs go to separate buffers (each thread reads its
// neighbours' old x), never in place.

#include "step_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const float* __restrict__ xT,   // (B, 3, L)
                    const float* __restrict__ gT,   // (B, 3, L) pair gradient
                    const float* __restrict__ muT,  // (B, 3, L)
                    const float* __restrict__ nuT,  // (B, 3, L)
                    const float* __restrict__ bm,   // (L,) bead mask
                    float* __restrict__ e_rows,     // (B, L) out: bond energy
                    float* __restrict__ xTo, float* __restrict__ muTo,
                    float* __restrict__ nuTo,       // (B, 3, L) out
                    int L, c3d::StepParams p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= L) return;
  const size_t off = (size_t)b * 3 * L;
  float gr[3] = {gT[off + i], gT[off + L + i], gT[off + 2 * L + i]};
  e_rows[(size_t)b * L + i] =
      c3d::update_bead(xT + off, bm, muT, nuT, xTo, muTo, nuTo, L, i, b, gr, p);
}

}  // namespace

extern "C" int c3d_fused_update(const float* xT, const float* gT,
                                const float* muT, const float* nuT,
                                const float* bm, float* e_rows, float* xTo,
                                float* muTo, float* nuTo, int B, int L,
                                float lr, float sigma, float b1, float b2,
                                float eps_adam, float bc1, float bc2,
                                float bond_w, float bond_len, float clip,
                                int seed, int step, void* stream) {
  const c3d::StepParams p{0.f, 0.f, lr, sigma, b1, b2, eps_adam, bc1, bc2,
                          bond_w, bond_len, clip, (uint32_t)seed,
                          (uint32_t)step};
  const dim3 grid((L + kThreads - 1) / kThreads, B);
  fused_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      xT, gT, muT, nuT, bm, e_rows, xTo, muTo, nuTo, L, p);
  return (int)cudaGetLastError();
}
