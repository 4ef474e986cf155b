// Kernel B3: the exact-restraint pair energy and gradient with each
// unordered (TM, TM) tile pair computed once, for a batch of structures
// sharing one restraint set.
//
// Replaces: chromosome3d_tpu/ops/pallas_energy.py `_kernel_exact_tri`
// (entry `pallas_energy_grad_tri_batched`). On the port's semi route it
// runs every step before kernel B4 (fused_update.cu), and once more for the
// enantiomer pick at L >= 1024: at the at-scale shape B = 20 then 10
// structures, L = 5120, T = 80 tiles of 64.
//
// Pairing: tiles on round-robin shells tj = (i + s) mod T, s = 0 .. T/2.
// The diagonal shell s = 0 holds both orders of its pairs (energy scale 1,
// row gradients only); every other shell holds each unordered pair once
// (energy scale 2, and the pair's column end gets its gradient too). For
// even T the last shell meets every pair {i, i + T/2} twice, so its
// i >= T/2 twin contributes nothing. Math per pair, in rsqrt space like the
// Pallas kernel:
//   s = |x_i - x_j|^2 + eps, rinv = rsqrt(s), pv = bead_i bead_j
//   u = 1 - t_ij rinv, v = max(r0 rinv - 1, 0), nb = (|i - j| >= 2) pv
//   e  += scale s (noe/2 w_ij pv u^2 + vdw/2 nb v^2)
//   c   = 2 noe w_ij pv u - 2 vdw nb v
//   g_i += c (x_i - x_j),  g_j -= c (x_i - x_j)
// The Pallas kernel forms the row gradient as x_i sum_j c_ij - (c @ X)_i
// and the column gradient as x_j sum_i c_ij - (X^T c)_j; at L = 5120 those
// cancel two large float32 terms over ten times more columns than at 512,
// so here each pair's force is summed over the differences already in
// registers (as in B1 and B2).
//
// What bounds it on an H100: ~35 FP32 operations and one MUFU rsqrt per
// unordered pair, B x L^2 / 2 pairs a call: at B = 20, L = 5120 that is
// 262M pairs, ~9 GFLOP — compute, not memory (the two (L, L) tiles are
// 210 MB, read once a call). Design: one block of 256 threads per tile
// pair (i, s); each thread keeps a 4 x 4 patch of t, w and the masks in
// registers, loaded from HBM once, and reuses it for all B structures (the
// point of the Pallas grid running the batch fastest). Per structure the
// row sums reduce over the 16 threads of a half-warp by shuffles and the
// column sums over the block through shared memory, in a fixed order.
// Partials go to a (B, 2S, 3, Lp) buffer — row partials of shell s at slot
// s, column partials at slot S + s — and a second kernel sums them per bead
// in slot order. No float atomics: the same inputs give the same bits,
// so a solve with a fixed seed is reproducible.

#include <cuda_runtime.h>

namespace {

constexpr int kTM = 64;         // tile edge
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 pairs each
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;
constexpr float kEps = 1e-12f;

struct TriParams {
  int B, L, T, S;
  float noe, vdw, r0;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
exact_tri_kernel(const float* __restrict__ xT,   // (B, 3, L)
                 const float* __restrict__ t,    // (L, L) targets
                 const float* __restrict__ w,    // (L, L) folded weights
                 const float* __restrict__ bm,   // (L,) bead mask
                 float* __restrict__ part,       // (B, 2S, 3, Lp) out
                 float* __restrict__ e_part,     // (B, T S) out
                 TriParams q) {
  __shared__ float col_sm[kWarps][3][kTM];
  __shared__ float e_sm[kWarps];
  const int T = q.T, S = q.S, L = q.L, Lp = q.T * kTM;
  const int blk = blockIdx.x;
  const int ti = blk % T, sh = blk / T;
  const int tj = (ti + sh) % T;
  const bool live = !((T % 2 == 0) && sh == S - 1 && ti >= T / 2);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = ti * kTM, col0 = tj * kTM;

  // this thread's pairs: rows row0 + ty + 16 a, columns col0 + tx + 16 k;
  // beads past L are zero (no restraint, no vdw)
  float tt[kPer][kPer], ww[kPer][kPer], nn[kPer][kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int r = row0 + ty + 16 * a;
    const float bmr = r < L ? bm[r] : 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = col0 + tx + 16 * k;
      const bool in = r < L && c < L;
      const float pv = in ? bmr * bm[c] : 0.f;
      const size_t idx = (size_t)r * L + c;
      tt[a][k] = in ? t[idx] : 0.f;
      ww[a][k] = in ? w[idx] * pv : 0.f;
      nn[a][k] = (abs(r - c) >= 2) ? pv : 0.f;
    }
  }
  const float half_noe = 0.5f * q.noe, half_vdw = 0.5f * q.vdw;
  const float two_noe = 2.0f * q.noe, two_vdw = 2.0f * q.vdw;
  const float e_scale = live ? (sh == 0 ? 1.0f : 2.0f) : 0.0f;
  const size_t slot = (size_t)3 * Lp;

  for (int b = 0; b < q.B; ++b) {
    const float* xb = xT + (size_t)b * 3 * L;
    float ar[kPer][3], xc[kPer][3];
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int r = row0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 3; ++c) ar[a][c] = r < L ? xb[c * L + r] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int col = col0 + tx + 16 * k;
#pragma unroll
      for (int c = 0; c < 3; ++c) xc[k][c] = col < L ? xb[c * L + col] : 0.f;
    }
    float e = 0.f, gr[kPer][3], gc[kPer][3];
#pragma unroll
    for (int a = 0; a < kPer; ++a)
#pragma unroll
      for (int c = 0; c < 3; ++c) gr[a][c] = gc[a][c] = 0.f;
    if (live) {
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const float dx = ar[a][0] - xc[k][0];
          const float dy = ar[a][1] - xc[k][1];
          const float dz = ar[a][2] - xc[k][2];
          float s = kEps + dx * dx;
          s = s + dy * dy;
          s = s + dz * dz;
          const float rinv = rsqrtf(s);
          const float u = 1.0f - tt[a][k] * rinv;
          const float wu = ww[a][k] * u;
          const float v = fmaxf(q.r0 * rinv - 1.0f, 0.f);
          const float nv = nn[a][k] * v;
          e += s * (half_noe * (wu * u) + half_vdw * (nv * v));
          const float cf = two_noe * wu - two_vdw * nv;
          const float fx = cf * dx, fy = cf * dy, fz = cf * dz;
          gr[a][0] += fx;
          gr[a][1] += fy;
          gr[a][2] += fz;
          gc[k][0] -= fx;
          gc[k][1] -= fy;
          gc[k][2] -= fz;
        }
      }
    }

    // energy: warp sums, then the warps in order (thread 0, below)
    e = warp_sum(e);
    if (lane == 0) e_sm[warp] = e;

    // rows: the 16 threads of a half-warp share rows (xor 1..8 stays inside)
    float* prow = part + ((size_t)b * 2 * S + sh) * slot + row0 + ty;
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float v = gr[a][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        if (tx == 0) prow[c * Lp + 16 * a] = v;
      }
    }

    // columns: the two half-warps, then the warps through shared memory
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = gc[k][c] + __shfl_xor_sync(0xffffffffu, gc[k][c], 16);
        if (lane < 16) col_sm[warp][c][tx + 16 * k] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < 3 * kTM) {
      const int c = threadIdx.x / kTM, col = threadIdx.x % kTM;
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) v += col_sm[wi][c][col];
      // the diagonal shell's rows already hold both ends of its pairs
      part[((size_t)b * 2 * S + S + sh) * slot + (size_t)c * Lp + col0 + col] =
          sh == 0 ? 0.f : v;
    }
    if (threadIdx.x == 0) {
      float et = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) et += e_sm[wi];
      e_part[(size_t)b * T * S + blk] = e_scale * et;
    }
    __syncthreads();  // col_sm and e_sm are reused by the next structure
  }
}

// gT[b, c, l] = sum over the 2S slots in order; e[b] = sum of the blocks'
// energies (block 0 of each structure), in a fixed order.
__global__ void __launch_bounds__(kThreads)
tri_reduce_kernel(const float* __restrict__ part,    // (B, 2S, 3, Lp)
                  const float* __restrict__ e_part,  // (B, nblk)
                  float* __restrict__ gT,            // (B, 3, L) out
                  float* __restrict__ e,             // (B,) out
                  int L, int Lp, int S2, int nblk) {
  __shared__ float e_sm[kWarps];
  const int b = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx < 3 * L) {
    const int c = idx / L, l = idx - c * L;
    const float* pp = part + ((size_t)b * S2 * 3 + c) * Lp + l;
    float g = 0.f;
    for (int s = 0; s < S2; ++s) g += pp[(size_t)s * 3 * Lp];
    gT[((size_t)b * 3 + c) * L + l] = g;
  }
  if (blockIdx.x != 0) return;
  float v = 0.f;
  for (int k = threadIdx.x; k < nblk; k += kThreads) v += e_part[(size_t)b * nblk + k];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) e_sm[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float et = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) et += e_sm[wi];
    e[b] = et;
  }
}

}  // namespace

// part: (B, 2 S, 3, T tile) scratch and e_part: (B, T S) scratch, both
// allocated by the caller; T = ceil(L / tile), S = T / 2 + 1.
extern "C" int c3d_exact_tri(const float* xT, const float* t, const float* w,
                             const float* bm, float* part, float* e_part,
                             float* gT, float* e, int B, int L, int T,
                             int tile, float noe, float vdw, float vdw_radius,
                             void* stream) {
  if (tile != kTM || T != (L + kTM - 1) / kTM) return (int)cudaErrorInvalidValue;
  const int S = T / 2 + 1;
  const TriParams q{B, L, T, S, noe, vdw, vdw_radius};
  cudaStream_t st = (cudaStream_t)stream;
  exact_tri_kernel<<<T * S, kThreads, 0, st>>>(xT, t, w, bm, part, e_part, q);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((3 * L + kThreads - 1) / kThreads, B);
  tri_reduce_kernel<<<grid, kThreads, 0, st>>>(part, e_part, gT, e, L, T * kTM,
                                               2 * S, T * S);
  return (int)cudaGetLastError();
}
