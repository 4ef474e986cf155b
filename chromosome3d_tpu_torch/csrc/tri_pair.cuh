// The tile-pair body shared by kernel B3 (exact_tri.cu: the whole pair
// matrix) and kernel B6 (exact_tri_strip.cu: one shard's row strip of it).
//
// Pairing: global row tile ig = row0t + i (i = 0 .. Tl - 1, the strip's own
// tiles; row0t = 0 and Tl = Tg for B3) meets column tile (ig + s) mod Tg on
// shells s = 0 .. Tg/2. The diagonal shell s = 0 holds both orders of its
// pairs (energy scale 1, row gradients only); every other shell holds each
// unordered pair once (energy scale 2, and the pair's column end gets its
// gradient too). For even Tg the last shell meets every pair {ig, ig + Tg/2}
// twice, so its ig >= Tg/2 twin contributes nothing. The union of the
// strips' blocks is B3's set of blocks: every unordered tile pair once
// across the shards. Math per pair, in rsqrt space like the Pallas kernels:
//   s = |x_i - x_j|^2 + eps, rinv = rsqrt(s), pv = bead_i bead_j
//   u = 1 - t_ij rinv, v = max(r0 rinv - 1, 0), nb = (|i - j| >= 2) pv
//   e  += scale s (noe/2 w_ij pv u^2 + vdw/2 nb v^2)
//   c   = 2 noe w_ij pv u - 2 vdw nb v
//   g_i += c (x_i - x_j),  g_j -= c (x_i - x_j)
// with i and j global bead indices. The Pallas kernels form the row gradient
// as x_i sum_j c_ij - (c @ X)_i and the column gradient as x_j sum_i c_ij -
// (X^T c)_j, which cancel two large float32 terms (ROADMAP §C); here each
// pair's force is summed over the differences already in registers.
//
// One block of 256 threads (16 x 16) per (tile, shell); each thread keeps a
// kPer x kPer patch of t, w and the masks in registers, loaded from HBM
// once, and reuses it for all B structures. Per structure the row sums
// reduce over the 16 threads of a half-warp by shuffles and the column sums
// over the block through shared memory, in a fixed order. Partials go to a
// (B, 2S, 3, W) buffer: row partials of shell s at slot s, position of the
// row in the strip; column partials at slot S + s, at the column tile's
// position (B3, W = Tg TM) or at the row tile's own position (B6, the
// compact layout of the Pallas strip kernel, W = Lb). Energies go to
// e_part[b, s Tl + i]. No float atomics: the same inputs give the same bits.
// TM = 8 leaves all but an 8 x 8 corner of the threads idle; it only serves
// strips whose height 64, 32 and 16 do not divide.

#pragma once

#include <cuda_runtime.h>

namespace c3d_tri {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-12f;

struct TriParams {
  int B, L;         // structures, global (padded) length
  int Tl, Tg, S;    // the strip's row tiles, global tiles, shells Tg / 2 + 1
  int row0t;        // the strip's first global row tile (0 for B3)
  int W;            // width of one partial slot
  int compact;      // column partials at the row tile's position (B6)
  float noe, vdw, r0;
};

// internal linkage: each source that includes this header gets its own
// kernel instantiations, so two objects in one library never register the
// same kernel twice
namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
tri_pair_kernel(const float* __restrict__ xT,   // (B, 3, L)
                const float* __restrict__ t,    // (Tl TM, L) target rows of the strip
                const float* __restrict__ w,    // (Tl TM, L) folded weights
                const float* __restrict__ bm,   // (L,) bead mask
                float* __restrict__ part,       // (B, 2S, 3, W) out
                float* __restrict__ e_part,     // (B, Tl S) out
                TriParams q) {
  constexpr int kPer = TM >= 16 ? TM / 16 : 1;
  __shared__ float col_sm[kWarps][3][TM];
  __shared__ float e_sm[kWarps];
  const int Tl = q.Tl, Tg = q.Tg, S = q.S, L = q.L, W = q.W;
  const int blk = blockIdx.x;
  const int ti = blk % Tl, sh = blk / Tl;
  const int ig = q.row0t + ti;
  const int tj = (ig + sh) % Tg;
  const bool live = !((Tg % 2 == 0) && sh == S - 1 && ig >= Tg / 2);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lrow0 = ti * TM;                 // the tile's rows in the strip
  const int row0 = ig * TM, col0 = tj * TM;  // global
  const bool active = TM >= 16 || (tx < TM && ty < TM);

  // this thread's pairs: rows row0 + ty + 16 a, columns col0 + tx + 16 k;
  // beads past L are zero (no restraint, no vdw)
  float tt[kPer][kPer], ww[kPer][kPer], nn[kPer][kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int r = row0 + ty + 16 * a;
    const int rl = lrow0 + ty + 16 * a;
    const float bmr = active && r < L ? bm[r] : 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = col0 + tx + 16 * k;
      const bool in = active && r < L && c < L;
      const float pv = in ? bmr * bm[c] : 0.f;
      const size_t idx = (size_t)rl * L + c;
      tt[a][k] = in ? t[idx] : 0.f;
      ww[a][k] = in ? w[idx] * pv : 0.f;
      nn[a][k] = (abs(r - c) >= 2) ? pv : 0.f;
    }
  }
  const float half_noe = 0.5f * q.noe, half_vdw = 0.5f * q.vdw;
  const float two_noe = 2.0f * q.noe, two_vdw = 2.0f * q.vdw;
  const float e_scale = live ? (sh == 0 ? 1.0f : 2.0f) : 0.0f;
  const size_t slot = (size_t)3 * W;
  const int col_out0 = q.compact ? lrow0 : col0;

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
    float* prow = part + ((size_t)b * 2 * S + sh) * slot + lrow0 + ty;
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float v = gr[a][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        if (tx == 0 && (TM >= 16 || ty < TM)) prow[c * W + 16 * a] = v;
      }
    }

    // columns: the two half-warps, then the warps through shared memory
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = gc[k][c] + __shfl_xor_sync(0xffffffffu, gc[k][c], 16);
        if (lane < 16 && (TM >= 16 || tx < TM)) col_sm[warp][c][tx + 16 * k] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < 3 * TM) {
      const int c = threadIdx.x / TM, col = threadIdx.x % TM;
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) v += col_sm[wi][c][col];
      // the diagonal shell's rows already hold both ends of its pairs
      part[((size_t)b * 2 * S + S + sh) * slot + (size_t)c * W + col_out0 + col] =
          sh == 0 ? 0.f : v;
    }
    if (threadIdx.x == 0) {
      float et = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) et += e_sm[wi];
      e_part[(size_t)b * Tl * S + blk] = e_scale * et;
    }
    __syncthreads();  // col_sm and e_sm are reused by the next structure
  }
}

// e = the sum of one structure's nblk block energies in a fixed order:
// thread k adds blocks k, k + 256, ..., then the warps, then thread 0 adds
// the warps in order. Called by every thread of a 256-thread block.
__device__ __forceinline__ void block_energy_sum(const float* __restrict__ ep,
                                                 int nblk, float* __restrict__ out) {
  __shared__ float e_sm[kWarps];
  float v = 0.f;
  for (int k = threadIdx.x; k < nblk; k += kThreads) v += ep[k];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) e_sm[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float et = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) et += e_sm[wi];
    *out = et;
  }
}

}  // namespace
}  // namespace c3d_tri
