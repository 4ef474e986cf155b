// Kernel B2: exact-restraint pair energy and gradient for a batch of
// structures sharing one restraint set.
//
// Replaces: chromosome3d_tpu/ops/pallas_energy.py `_kernel_exact`, reached
// through `_pairwise_energy_grad_batched(..., exact=True)` (B2: all L rows)
// and through `pallas_row_block_energy_grad_batched(..., exact=True)` (B2':
// the Lb rows [row0, row0 + Lb) of one shard of the row-sharded solve, from
// (Lb, L) strips of the tiles; one body, so B2' rows are bitwise B2's). On
// the port's `run` path B2 runs once per solve: the enantiomer pick
// (chromosome3d_tpu/solver/anneal.py:564), B = 2 x models, L = the bucket.
// B2' runs every step and at the pick of a sharded exact solve where the
// strip-triangular kernel B6 does not pay (L = 512 over 2 shards).
//
// Math, in d-space as the Pallas kernel does it (the pick compares these
// energies with an argmin, so B1's rsqrt-space algebra is not borrowed):
//   s = |x_i - x_j|^2 + eps, rinv = rsqrt(s), d = s * rinv
//   pv = bead_i * bead_j, nb = (|i - j| >= 2) * pv
//   dev = d - t_ij, overlap = max(r0 - d, 0)
//   e_i = 1/2 noe sum_j w_ij pv dev^2 + 1/2 vdw sum_j nb overlap^2
//   c_ij = (2 noe w_ij pv dev - 2 vdw nb overlap) * rinv
//   g_i = sum_j c_ij (x_i - x_j)
// The Pallas kernel forms g_i as x_i sum_j c_ij - (c @ X)_i on the MXU; here
// the differences are already in registers, and summing c (x_i - x_j)
// avoids the float32 cancellation between those two large terms (at L = 512
// with coordinates of tens of A they are ~1e4 apart from a result of ~10).
// Each unordered pair is seen from both rows (the 1/2 ordered-pair
// convention), so every row owns its gradient and no atomics are needed.
//
// What bounds it on an H100: ~30 FP32 operations and one MUFU rsqrt per
// pair, and two (L, L) float32 tiles (target, weight) read once per
// structure. At the pick's shape (B = 20, L = 512) that is 5.2M pairs
// (~0.16 GFLOP) and 2 MiB of tiles, far below what the card streams in the
// launch overhead of one call; torch.profiler measured 13.6 us a launch
// (NVIDIA H100 80GB HBM3, 700.00 W). Design: one warp per bead row, grid
// (row blocks, B).
// Lanes stride the columns, so each tile row is read coalesced; the 20
// structures re-read the same 2 MiB of tiles, which stay in the 50 MB L2.
// The row's sums live in registers and are reduced with warp shuffles.
// Reusing a tile row across structures inside one block is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
exact_pair_kernel(const float* __restrict__ x,     // (B, L, 3)
                  const float* __restrict__ t,     // (Lb, L) targets, rows row0..
                  const float* __restrict__ w,     // (Lb, L) folded weights
                  const float* __restrict__ bm,    // (L,) bead mask
                  float* __restrict__ e_rows,      // (B, Lb) out
                  float* __restrict__ g,           // (B, Lb, 3) out
                  int L, int row0, int Lb, float noe, float vdw, float r0) {
  const int lane = threadIdx.x & 31;
  const int il = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (il >= Lb) return;  // uniform per warp: the shuffles below stay full-warp
  const int i = row0 + il;

  const float* xb = x + (size_t)b * L * 3;
  const float ax = xb[3 * i], ay = xb[3 * i + 1], az = xb[3 * i + 2];
  const float bmi = bm[i];
  const float* trow = t + (size_t)il * L;
  const float* wrow = w + (size_t)il * L;

  float e_noe = 0.f, e_vdw = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
  for (int j = lane; j < L; j += 32) {
    const float xj = xb[3 * j], yj = xb[3 * j + 1], zj = xb[3 * j + 2];
    const float dx = ax - xj, dy = ay - yj, dz = az - zj;
    const float s = dx * dx + dy * dy + dz * dz + kEps;
    const float rinv = rsqrtf(s);
    const float d = s * rinv;
    const float pv = bmi * bm[j];
    const float wv = wrow[j] * pv;
    const float dev = d - trow[j];
    e_noe += wv * dev * dev;
    const float nb = (abs(i - j) >= 2) ? pv : 0.f;
    const float ov = fmaxf(r0 - d, 0.f);
    e_vdw += nb * ov * ov;
    const float c = (noe * wv * (2.f * dev) - 2.f * vdw * nb * ov) * rinv;
    gx += c * dx;
    gy += c * dy;
    gz += c * dz;
  }
  e_noe = warp_sum(e_noe);
  e_vdw = warp_sum(e_vdw);
  gx = warp_sum(gx);
  gy = warp_sum(gy);
  gz = warp_sum(gz);
  if (lane == 0) {
    const size_t r = (size_t)b * Lb + il;
    e_rows[r] = 0.5f * noe * e_noe + 0.5f * vdw * e_vdw;
    g[3 * r] = gx;
    g[3 * r + 1] = gy;
    g[3 * r + 2] = gz;
  }
}

}  // namespace

// B2 is row0 = 0, Lb = L; B2' a shard's rows [row0, row0 + Lb).
extern "C" int c3d_exact_pair(const float* x, const float* t, const float* w,
                              const float* bm, float* e_rows, float* g, int B,
                              int L, int row0, int Lb, float noe, float vdw,
                              float vdw_radius, void* stream) {
  if (row0 < 0 || Lb <= 0 || row0 + Lb > L) return (int)cudaErrorInvalidValue;
  const dim3 grid((Lb + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  exact_pair_kernel<<<grid, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      x, t, w, bm, e_rows, g, L, row0, Lb, noe, vdw, vdw_radius);
  return (int)cudaGetLastError();
}

extern "C" const char* c3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
