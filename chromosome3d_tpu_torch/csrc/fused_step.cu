// Kernel B1: one whole annealing step for a batch of structures sharing one
// restraint set — pair energy and gradient, chain bond, per-bead gradient
// clip, Adam with the bias corrections passed in, CLT-4 Langevin noise and
// the coordinate update.
//
// Replaces: chromosome3d_tpu/ops/pallas_energy.py `_kernel_fused_step`
// (entry `pallas_fused_step_batched`), with its helpers `_t_layout_bond`
// and `_t_layout_noise`. On the port's main path it runs every step of the
// hot, cool and final phases (B = 2 x models, then B = models; L = the
// length bucket).
//
// Pair terms use the exact-restraint algebra in rsqrt space:
//   s = |x_i - x_j|^2 + eps, rinv = rsqrt(s)
//   u = 1 - t_ij rinv, v = max(r0 rinv - 1, 0)
//   c_ij = w_ij u - 2 vdw nb_ij v              (the force coefficient)
//   e_i  = sum_j s (w_ij u^2 / 4 + vdw nb_ij v^2 / 2)
//   g_i  = sum_j c_ij (x_i - x_j)
// (the Pallas kernel's x_i sum_j c_ij - (c @ X)_i, summed over the
// differences already in registers: no float32 cancellation between two
// large terms; see exact_pair.cu).
// The tiles come from fused_step_tiles: w pre-scaled by 2 noe and pre-masked
// by bead validity, nb the pre-masked vdw predicate (|i - j| >= 2).
//
// What bounds it on an H100: ~30 FP32 operations and one MUFU rsqrt per
// pair, and three (L, L) float32 tiles read per structure. At the main
// path's shape (B = 20 then 10, L = 512) a step is 5.2M (then 2.6M) pairs
// and 3 MiB of tiles, so it is bound by latency — launch, the column loop's
// dependent chain, the per-warp serial tail — not by FLOP/s or HBM;
// torch.profiler measured 19.3 us a launch at B = 20 and 11.2 us at B = 10
// (NVIDIA H100 80GB HBM3, 700.00 W). Design: one warp per bead row, grid
// (row blocks, B). Lanes stride the columns: tile rows and the (3, L) "T
// layout" state are read coalesced, the structures re-read the tiles from
// the 50 MB L2, and the row's sums stay in registers (warp-shuffle
// reduction). Lane 0 then finishes the row's bead: it reads x[i-1] and
// x[i+1] from the OLD x for the bond term (the Pallas kernel staged the
// whole chain in scratch instead). Every block reads the whole old x, so
// x', mu' and nu' go to separate buffers and the caller swaps them each
// step — never in place.
//
// The per-bead half (bond, clip, Adam, noise, move) and the noise's bit
// contract live in step_common.cuh, shared with kernel B4.

#include "step_common.cuh"

namespace {

using c3d::kEps;
using c3d::StepParams;

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_step_kernel(const float* __restrict__ xT,   // (B, 3, L)
                  const float* __restrict__ muT,  // (B, 3, L)
                  const float* __restrict__ nuT,  // (B, 3, L)
                  const float* __restrict__ t,    // (L, L) targets
                  const float* __restrict__ w,    // (L, L) 2 noe w pv
                  const float* __restrict__ nb,   // (L, L) vdw predicate
                  const float* __restrict__ bm,   // (L,) bead mask
                  float* __restrict__ e_rows,     // (B, L) out
                  float* __restrict__ xTo, float* __restrict__ muTo,
                  float* __restrict__ nuTo,       // (B, 3, L) out
                  int L, StepParams p) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (i >= L) return;  // uniform per warp

  const float* xb = xT + (size_t)b * 3 * L;
  const float a[3] = {xb[i], xb[L + i], xb[2 * L + i]};
  const float* trow = t + (size_t)i * L;
  const float* wrow = w + (size_t)i * L;
  const float* nrow = nb + (size_t)i * L;
  const float half_vdw = 0.5f * p.vdw, two_vdw = 2.0f * p.vdw;

  // ---- pair sweep: lanes stride the columns ----
  float e = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
  for (int j = lane; j < L; j += 32) {
    const float xj = xb[j], yj = xb[L + j], zj = xb[2 * L + j];
    const float dx = a[0] - xj, dy = a[1] - yj, dz = a[2] - zj;
    float s = kEps + dx * dx;
    s = s + dy * dy;
    s = s + dz * dz;
    const float rinv = rsqrtf(s);
    const float u = 1.0f - trow[j] * rinv;
    const float wtu = wrow[j] * u;
    const float v = fmaxf(p.vdw_radius * rinv - 1.0f, 0.f);
    const float nv = nrow[j] * v;
    e += s * (0.25f * (wtu * u) + half_vdw * (nv * v));
    const float c = wtu - two_vdw * nv;
    gx += c * dx;
    gy += c * dy;
    gz += c * dz;
  }
  e = warp_sum(e);
  gx = warp_sum(gx);
  gy = warp_sum(gy);
  gz = warp_sum(gz);
  if (lane != 0) return;

  // ---- the row's bead: bond, clip, Adam, noise, move ----
  float gr[3] = {gx, gy, gz};
  const float e_bond =
      c3d::update_bead(xb, bm, muT, nuT, xTo, muTo, nuTo, L, i, b, gr, p);
  e_rows[(size_t)b * L + i] = e + e_bond;
}

}  // namespace

extern "C" int c3d_fused_step(const float* xT, const float* muT,
                              const float* nuT, const float* t, const float* w,
                              const float* nb, const float* bm, float* e_rows,
                              float* xTo, float* muTo, float* nuTo, int B,
                              int L, float vdw, float vdw_radius, float lr,
                              float sigma, float b1, float b2, float eps_adam,
                              float bc1, float bc2, float bond_w,
                              float bond_len, float clip, int seed, int step,
                              void* stream) {
  const StepParams p{vdw, vdw_radius, lr, sigma, b1, b2, eps_adam, bc1, bc2,
                     bond_w, bond_len, clip, (uint32_t)seed, (uint32_t)step};
  const dim3 grid((L + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  fused_step_kernel<<<grid, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      xT, muT, nuT, t, w, nb, bm, e_rows, xTo, muTo, nuTo, L, p);
  return (int)cudaGetLastError();
}
