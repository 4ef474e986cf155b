// Kernel B5: general-restraint pair energy and gradient (soft-square
// flat-bottom well on [lo, hi] with linear tails past noe_rswitch, plus the
// vdw repel) for a batch of structures sharing one restraint set.
//
// Replaces: chromosome3d_tpu/ops/pallas_energy.py `_kernel`, reached through
// `_pairwise_energy_grad_batched(..., exact=False)` (B5: all L rows) and
// through `pallas_row_block_energy_grad_batched(..., exact=False)` (B5': the
// Lb rows [row_start, row_start + Lb) of one shard of the row-sharded solve,
// from (Lb, L) strips of the tiles). One body serves both: a row's sums do
// not depend on which rows share the launch, so B5' rows are bitwise B5's.
// On the port's `solve` path for windowed restraint files it runs every
// annealing step (before kernel B4) and once for the enantiomer pick (B = 2 x
// models, then models; L = the bucket, or the shard-quantum length past the
// buckets; sharded: once per shard each time).
//
// Math, in d-space as the Pallas kernel does it:
//   s = |x_i - x_j|^2 + eps, rinv = rsqrt(s), d = s * rinv
//   pv = bead_i * bead_j, nb = (|i - j| >= 2) * pv, wv = w_ij * pv
//   over = max(d - hi, 0), under = max(lo - d, 0), viol = over + under
//   quad = viol <= rs
//   well = quad ? viol^2 : rs^2 + 2 rs (viol - rs)
//   dwell = quad ? 2 viol : 2 rs
//   sgn = over > 0 ? 1 : (under > 0 ? -1 : 0)
//   e_i = 1/2 noe sum_j wv well + 1/2 vdw sum_j nb overlap^2
//   c_ij = (noe wv dwell sgn - 2 vdw nb overlap) * rinv
//   g_i = sum_j c_ij (x_i - x_j)
// The Pallas kernel forms g_i as x_i sum_j c_ij - (c @ X)_i; that cancels
// large float32 terms (ROADMAP §C), so the differences already in registers
// are summed instead, as B1-B3 do.
//
// What bounds it on an H100: ~40 FP32 operations and one MUFU rsqrt per
// ordered pair (B x L^2 pairs a call: 524M at B = 20, L = 5120), and three
// (L, L) float32 tiles lo, hi, w (315 MB at L = 5120, six times the 50 MB
// L2). The Pallas grid reads each tile row from HBM once per call for all B
// structures (batch fastest); a grid of (rows, B) would stream the tiles B
// times (6.3 GB a hot step). Design: one block per bead row i stages row i
// of lo, hi and w and the bead mask in shared memory (80 KB at L = 5120,
// dynamic; row i of a shard's strip), then every warp sweeps a fixed strided slice of the columns for
// each of the B structures in turn: lanes take neighbouring columns, so the
// xT reads of (B, 3, L) are coalesced, and every warp gets the same share of
// every structure. Each warp reduces its sums with shuffles and leaves them
// in shared memory; one thread per structure then adds the warps' partials
// in warp order. No atomics: equal inputs give equal bits. The (B, 3, L)
// layout in and out lets the step feed kernel B4 with no transposes.
// wgmma / TMA tiling is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
general_pair_kernel(const float* __restrict__ xT,   // (B, 3, L)
                    const float* __restrict__ lo,   // (Lb, L) rows row0..
                    const float* __restrict__ hi,   // (Lb, L)
                    const float* __restrict__ w,    // (Lb, L) mask * weight
                    const float* __restrict__ bm,   // (L,) bead mask
                    float* __restrict__ e_rows,     // (B, Lb) out
                    float* __restrict__ gT,         // (B, 3, Lb) out
                    int B, int L, int row0, int Lb, float noe, float vdw,
                    float r0, float rs) {
  extern __shared__ float smem[];
  float* s_lo = smem;
  float* s_hi = s_lo + L;
  float* s_w = s_hi + L;
  float* s_bm = s_w + L;
  float* s_part = s_bm + L;   // (B, kWarps, 5) per-warp sums

  const int il = blockIdx.x;        // the strip's row
  const int i = row0 + il;          // the same row of the pair matrix
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = (size_t)il * L;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    s_lo[j] = lo[row + j];
    s_hi[j] = hi[row + j];
    s_w[j] = w[row + j];
    s_bm[j] = bm[j];
  }
  __syncthreads();

  const float bmi = s_bm[i];
  const float two_rs = 2.f * rs;
  const float rs_sq = rs * rs;
  for (int b = 0; b < B; ++b) {
    const float* xb = xT + (size_t)b * 3 * L;
    const float ax = xb[i], ay = xb[L + i], az = xb[2 * L + i];
    float e_noe = 0.f, e_vdw = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
    for (int j = warp * 32 + lane; j < L; j += kWarps * 32) {
      const float dx = ax - xb[j], dy = ay - xb[L + j], dz = az - xb[2 * L + j];
      const float s = dx * dx + dy * dy + dz * dz + kEps;
      const float rinv = rsqrtf(s);
      const float d = s * rinv;
      const float pv = bmi * s_bm[j];
      const float wv = s_w[j] * pv;
      const float over = fmaxf(d - s_hi[j], 0.f);
      const float under = fmaxf(s_lo[j] - d, 0.f);
      const float viol = over + under;
      const bool quad = viol <= rs;
      const float well = quad ? viol * viol : rs_sq + two_rs * (viol - rs);
      const float dwell = quad ? 2.f * viol : two_rs;
      const float sgn = over > 0.f ? 1.f : (under > 0.f ? -1.f : 0.f);
      e_noe += wv * well;
      const float nb = (abs(i - j) >= 2) ? pv : 0.f;
      const float ov = fmaxf(r0 - d, 0.f);
      e_vdw += nb * ov * ov;
      const float c = (noe * wv * dwell * sgn - 2.f * vdw * nb * ov) * rinv;
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
      float* p = s_part + ((size_t)b * kWarps + warp) * 5;
      p[0] = e_noe;
      p[1] = e_vdw;
      p[2] = gx;
      p[3] = gy;
      p[4] = gz;
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const float* p = s_part + (size_t)b * kWarps * 5;
    float e_noe = 0.f, e_vdw = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
    for (int k = 0; k < kWarps; ++k) {
      e_noe += p[5 * k];
      e_vdw += p[5 * k + 1];
      gx += p[5 * k + 2];
      gy += p[5 * k + 3];
      gz += p[5 * k + 4];
    }
    e_rows[(size_t)b * Lb + il] = 0.5f * noe * e_noe + 0.5f * vdw * e_vdw;
    float* gb = gT + (size_t)b * 3 * Lb;
    gb[il] = gx;
    gb[Lb + il] = gy;
    gb[2 * Lb + il] = gz;
  }
}

}  // namespace

// B5 is row0 = 0, Lb = L; B5' a shard's rows [row0, row0 + Lb).
extern "C" int c3d_general_pair(const float* xT, const float* lo, const float* hi,
                                const float* w, const float* bm, float* e_rows,
                                float* gT, int B, int L, int row0, int Lb,
                                float noe, float vdw, float vdw_radius,
                                float rswitch, void* stream) {
  if (row0 < 0 || Lb <= 0 || row0 + Lb > L) return (int)cudaErrorInvalidValue;
  // four staged rows and the per-warp partial sums; past the card's 227 KB
  // a block can opt into, the attribute call fails and the wrapper raises
  const size_t smem = (4 * (size_t)L + 5 * (size_t)kWarps * B) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      general_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  general_pair_kernel<<<Lb, kWarps * 32, smem, (cudaStream_t)stream>>>(
      xT, lo, hi, w, bm, e_rows, gT, B, L, row0, Lb, noe, vdw, vdw_radius,
      rswitch);
  return (int)cudaGetLastError();
}
