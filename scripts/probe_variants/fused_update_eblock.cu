// Kernel B4 with no cross-block tail: one extra block a structure sums that
// structure's bond energies itself, and every block takes the counter's
// ticket as soon as it has read the step. Entry c3d_fused_update_eblock.
//
// Grid (1 + ceil(L / 256), B). Block 0 of structure b recomputes its L - 1
// bonds with `bond_forward` (the x it reads is the launch's input, which no
// block writes), sums them in a fixed order (a thread's beads in order, the
// warp's lanes over a butterfly, the warps in order) and writes
// hist[k - first, b] = e_pair[b] + that sum; blocks 1.. are the bead
// blocks, one thread a (bead, structure), as the shipped kernel's. Thread 0
// of every block reads k with an acquire load and then draws a ticket, so
// the block that draws the last one knows every block has read k and moves
// the counter on when it ends. No fence and no block waits on another.

#include "step_common.cuh"
#include "warp_fold.cuh"

namespace {

using c3d::kThreads;
using c3d::kWarps;
constexpr unsigned kFull = 0xffffffffu;
// beads an energy-block thread loads at a time, and the blocks an SM the
// registers must leave room for (-D to try others)
#ifndef C3D_EBATCH
#define C3D_EBATCH 4
#endif
#ifndef C3D_MINB
#define C3D_MINB 4
#endif
constexpr int kBatch = C3D_EBATCH;

struct UpdateConsts {
  int B, L, first, rows, hist_stride;
  float b1, b2, eps_adam, bond_w, bond_len, clip;
  uint32_t seed;
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// structure xb's bond energies, summed in a fixed order; the result is in
// thread 0. Called by every thread of the block.
__device__ __forceinline__ float bond_energy_sum(const float* __restrict__ xb,
                                                 const float* __restrict__ bm, int L,
                                                 const c3d::StepParams& p,
                                                 float* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float e = 0.f;
  for (int r0 = 0; r0 < L; r0 += kThreads * kBatch) {
    float a[kBatch][3], h[kBatch][3], bmi[kBatch], bmh[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int i = r0 + r * kThreads + tid, j = i + 1;
      const bool in = i < L, hin = lane == 31 && j < L;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a[r][c] = in ? __ldcg(xb + (size_t)c * L + i) : 0.f;
        h[r][c] = hin ? __ldcg(xb + (size_t)c * L + j) : 0.f;
      }
      bmi[r] = in ? __ldg(bm + i) : 0.f;
      bmh[r] = hin ? __ldg(bm + j) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int i = r0 + r * kThreads + tid;
      float nx[3], fwd[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float up = __shfl_down_sync(kFull, a[r][c], 1);
        nx[c] = lane == 31 ? h[r][c] : up;
      }
      const float bup = __shfl_down_sync(kFull, bmi[r], 1);
      const float bmn = lane == 31 ? bmh[r] : bup;
      if (i + 1 < L) e += c3d::bond_forward(a[r], nx, bmi[r] * bmn, p, fwd);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(kFull, e, off);
  if (lane == 0) s_warp[warp] = e;
  __syncthreads();
  float t = 0.f;
  if (tid == 0)
    for (int wq = 0; wq < kWarps; ++wq) t += s_warp[wq];
  return t;
}

__global__ void __launch_bounds__(kThreads, C3D_MINB)
fused_update_kernel(const float* __restrict__ xT, const float* __restrict__ gT,
                    const float* __restrict__ muT, const float* __restrict__ nuT,
                    const float* __restrict__ bm, const float* __restrict__ e_pair,
                    const float* __restrict__ table, int* __restrict__ step,
                    float* __restrict__ hist, int* __restrict__ ticket,
                    float* __restrict__ xTo, float* __restrict__ muTo,
                    float* __restrict__ nuTo, UpdateConsts q) {
  __shared__ float s_warp[kWarps];
  __shared__ int s_k;
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.y, L = q.L;
  const bool energy = blockIdx.x == 0;
  const int i = ((int)blockIdx.x - 1) * kThreads + tid;
  const bool live = !energy && i < L;
  const size_t at = (size_t)b * 3 * L + i;

  float a[3] = {0.f, 0.f, 0.f}, g0[3] = {0.f, 0.f, 0.f};
  float mu[3] = {0.f, 0.f, 0.f}, nu[3] = {0.f, 0.f, 0.f}, halo[3] = {0.f, 0.f, 0.f};
  float bmi = 0.f, bmh = 0.f;
  if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[c] = __ldcg(xT + at + (size_t)c * L);
      g0[c] = __ldcg(gT + at + (size_t)c * L);
      mu[c] = __ldcg(muT + at + (size_t)c * L);
      nu[c] = __ldcg(nuT + at + (size_t)c * L);
    }
    bmi = __ldg(bm + i);
    const int h = lane == 0 ? i - 1 : i + 1;
    if ((lane == 0 || lane == 31) && h >= 0 && h < L) {
#pragma unroll
      for (int c = 0; c < 3; ++c) halo[c] = __ldcg(xT + at + (size_t)c * L + (h - i));
      bmh = __ldg(bm + h);
    }
  }
  const float ep = energy && tid == 0 ? __ldg(e_pair + b) : 0.f;
  bool last = false;
  if (tid == 0) {
    const int k = load_acquire(step);
    s_k = k;
    last = atomicAdd(ticket, 1) == (int)(gridDim.x * gridDim.y) - 1;
  }
  __syncthreads();
  const int k = s_k;
  if (k < q.first || k - q.first >= q.rows) __trap();   // a step outside the table

  c3d::StepParams p;
  p.vdw = 0.f;
  p.vdw_radius = 0.f;
  p.b1 = q.b1;
  p.b2 = q.b2;
  p.eps_adam = q.eps_adam;
  p.bond_w = q.bond_w;
  p.bond_len = q.bond_len;
  p.clip = q.clip;
  p.seed = q.seed;
  p.step = (uint32_t)k;
  if (energy) {
    p.lr = p.sigma = p.bc1 = p.bc2 = 0.f;
    const float eb = bond_energy_sum(xT + (size_t)b * 3 * L, bm, L, p, s_warp);
    if (tid == 0) hist[(size_t)(k - q.first) * q.hist_stride + b] = ep + eb;
  } else {
    const float* row = table + (size_t)(k - q.first) * c3d::kTableCols;
    p.lr = __ldg(row + 0);
    p.sigma = __ldg(row + 1);
    p.bc1 = __ldg(row + 4);
    p.bc2 = __ldg(row + 5);
    float nx[3], pv[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float up = __shfl_down_sync(kFull, a[c], 1);
      const float dn = __shfl_up_sync(kFull, a[c], 1);
      nx[c] = lane == 31 ? halo[c] : up;
      pv[c] = lane == 0 ? halo[c] : dn;
    }
    const float bm_up = __shfl_down_sync(kFull, bmi, 1);
    const float bm_dn = __shfl_up_sync(kFull, bmi, 1);
    const float bmn = lane == 31 ? bmh : bm_up, bmp = lane == 0 ? bmh : bm_dn;
    float fwd[3] = {0.f, 0.f, 0.f}, fwd_prev[3] = {0.f, 0.f, 0.f};
    if (i + 1 < L) c3d::bond_forward(a, nx, bmi * bmn, p, fwd);
    if (i > 0) c3d::bond_forward(pv, a, bmp * bmi, p, fwd_prev);
    float gr[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) gr[c] = g0[c] + (fwd_prev[c] - fwd[c]);
    const float scale = c3d::clip_scale(gr, p);
    const uint32_t base = c3d::noise_base(p, b);
    if (live) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float g = gr[c];
        if (p.clip > 0.f) g = g * scale;
        const float xo = c3d::adam_move(a[c], g, mu[c], nu[c], bmi, (uint32_t)(i * 3 + c),
                                        base, p);
        xTo[at + (size_t)c * L] = xo;
        muTo[at + (size_t)c * L] = mu[c];
        nuTo[at + (size_t)c * L] = nu[c];
      }
    }
  }
  if (last) {
    *step = k + 1;
    *ticket = 0;
  }
}

}  // namespace

extern "C" int c3d_fused_update_eblock(const float* xT, const float* gT, const float* muT,
                                       const float* nuT, const float* bm,
                                       const float* e_pair, const float* table, int* step,
                                       float* hist, int* ticket, float* xTo, float* muTo,
                                       float* nuTo, int B, int L, int first, int rows,
                                       int hist_stride, float b1, float b2, float eps_adam,
                                       float bond_w, float bond_len, float clip, int seed,
                                       void* stream) {
  if (B <= 0 || L <= 0 || rows <= 0 || hist_stride < B) return (int)cudaErrorInvalidValue;
  const UpdateConsts q{B, L, first, rows, hist_stride, b1, b2, eps_adam, bond_w, bond_len,
                       clip, (uint32_t)seed};
  const dim3 grid(1 + (L + kThreads - 1) / kThreads, B);
  fused_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      xT, gT, muT, nuT, bm, e_pair, table, step, hist, ticket, xTo, muTo, nuTo, q);
  return (int)cudaGetLastError();
}
