// Kernel B2: exact-restraint pair energy and gradient for a batch of
// structures sharing one restraint set, or for the chromosomes of a genome
// bucket, each with its own (structure b reads chromosome b / n_per's tiles
// and bead mask).
//
// Replaces: chromosome3d_tpu/ops/pallas_energy.py `_kernel_exact`, reached
// through `_pairwise_energy_grad_batched(..., exact=True)` (B2: all L rows)
// and through `pallas_row_block_energy_grad_batched(..., exact=True)` (B2':
// the Lb rows [row0, row0 + Lb) of one shard of the row-sharded solve, from
// (Lb, L) strips of the tiles, or (C, Lb, L) strips of a genome group's C
// chromosomes, their (C, L) bead masks read at the global row; one body, so
// B2' rows are bitwise B2's). On
// the port's `run` path B2 runs once per solve, for the enantiomer pick
// (B = 20, L = 512); B2' runs on every shard every step of a sharded exact
// solve where the strip-triangular kernel B6 does not pay (Lb = 256 of
// L = 512 over 2 shards, B = 20 then 10).
//
// Math, in d-space as the Pallas kernel does it (the pick compares these
// energies with an argmin, so B1's rsqrt-space algebra is not borrowed):
//   s = |x_i - x_j|^2 + eps, rinv = rsqrt(s), d = s * rinv
//   pv = bead_i * bead_j, nb = (|i - j| >= 2) * pv
//   dev = d - t_ij, overlap = max(r0 - d, 0)
//   e = 1/2 noe sum_ij w_ij pv dev^2 + 1/2 vdw sum_ij nb overlap^2
//   c_ij = (2 noe w_ij pv dev - 2 vdw nb overlap) * rinv
//   g_i = sum_j c_ij (x_i - x_j)
// The Pallas kernel forms g_i as x_i sum_j c_ij - (c @ X)_i on the MXU; here
// the differences are already in registers, and summing c (x_i - x_j)
// avoids the float32 cancellation between those two large terms (ROADMAP
// §C). Each unordered pair is seen from both rows (the 1/2 ordered-pair
// convention), so every row owns its gradient.
//
// What bounds it on an H100: at the shapes it runs, latency. B x Lb x L
// pairs (5.2M at the pick, 1.3-2.6M a shard step) at ~30 instructions each
// are 1-5 us of issue on 132 SMs, and the (Lb, L) tiles (0.5-1 MiB) stay in
// L2 for every structure. Design: a warp owns one row of one structure and
// its lanes stride the L columns, so every load (three rows of xT, the bead
// mask, t and w) is coalesced and a row's gradient never leaves its warp;
// grid (ceil(Lb / 8), B), 640-1,280 blocks of 8 warps. A row's 4 sums go
// through one multi-value butterfly (warp_fold.cuh); the lanes that own the
// gradient write the (B, 3, Lb) rows. Each block writes its 8 rows' energy,
// and the last block to arrive (a ticket: one atomic counter) adds every
// structure's block sums in a fixed order into e (B,). (A body that kept a
// lane's tiles in registers for a slice of structures and staged the
// coordinates by cp.async was slower at all three shapes:
// scripts/variant_probe_torch.py, PERF.md §6.) A row's columns are summed in
// the same order whatever rows share the launch, and every product and sum
// is spelled as fmaf or a never-fused intrinsic, so B2' rows are B2's bits,
// and a genome bucket's chromosome c (structure b reads the tiles and bead
// mask of chromosome b / n_per) has the bits of a launch of its own. At the
// bucket's shape (45 chromosomes x 20 structures, L = 512; 28,800 blocks)
// the pick is one launch of 0.623 ms against a bound of 0.123 (45 lone
// launches: 45 x 0.018; NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py).
// No float atomics: equal inputs give equal bits.
//
// The tiles t and w are float32 or bfloat16 (AnnealConfig.pair_bf16: the
// JAX package casts them to bf16 before `_kernel_exact`, which converts on
// read, pallas_energy.py:238-241, 860-866); the body is a template on their
// type and widens each element on load (tile_load.cuh), so the bf16 entry
// point halves the tile bytes and gives the bits of the float32 one on the
// widened tiles. Everything else stays float32.

#include <cuda_runtime.h>

#include "tile_load.cuh"
#include "warp_fold.cuh"

namespace {

using c3d::kThreads;
using c3d::kWarps;

constexpr int kVals = 4;          // a row's sums: the gradient's 3, the energy
constexpr int kStageMax = 2048;   // block energies the last block stages
constexpr float kEps = 1e-12f;

// The last block of the launch (the one that drew the last ticket): out(b,
// sum) for every b < B, sum adding p[b n .. b n + n) in a fixed order —
// lane-strided sums, then a butterfly over the warp — one warp a row. The
// values are staged in `stage` (stage_max floats of shared memory) when
// they fit, so every load is issued before the first sum. They were
// written by other blocks of this launch: read through L2. Called by every
// thread of the block.
template <typename Out>
__device__ __forceinline__ void last_block_row_sums(const float* __restrict__ p, int B,
                                                    int n, float* stage, int stage_max,
                                                    Out out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool staged = B * n <= stage_max;
  if (staged)
    for (int m = threadIdx.x; m < B * n; m += kThreads) stage[m] = __ldcg(p + m);
  __syncthreads();
  for (int b = warp; b < B; b += kWarps) {
    float v = 0.f;
    for (int m = lane; m < n; m += 32)
      v += staged ? stage[(size_t)b * n + m] : __ldcg(p + (size_t)b * n + m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) out(b, v);
  }
}

template <typename TT>
__global__ void __launch_bounds__(kThreads)
exact_pair_kernel(const float* __restrict__ xT,   // (B, 3, L)
                  const TT* __restrict__ t,       // (C, Lb, L) targets, rows row0..
                  const TT* __restrict__ w,       // (C, Lb, L) folded weights
                  const float* __restrict__ bm,   // (C, L) bead masks
                  float* __restrict__ gT,         // (B, 3, Lb) out
                  float* __restrict__ e,          // (B,) out
                  float* __restrict__ e_part,     // (B, row groups) scratch
                  int* __restrict__ ticket,       // 0 between launches
                  int B, int L, int row0, int Lb, int n_per, float two_noe,
                  float two_vdw, float r0) {
  __shared__ float s_e[kWarps];
  __shared__ float s_stage[kStageMax];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = blockIdx.x, b = blockIdx.y;
  const int il = rg * kWarps + warp, i = row0 + il;   // the warp's row
  const bool row_in = il < Lb;
  const float* xb = xT + (size_t)b * 3 * L;
  // structure b belongs to chromosome b / n_per: its tiles and bead mask
  const int c = b / n_per;
  t += (size_t)c * Lb * L;
  w += (size_t)c * Lb * L;
  bm += (size_t)c * L;
  float v[kVals] = {0.f, 0.f, 0.f, 0.f};
  if (row_in) {
    const float ax = __ldg(xb + i), ay = __ldg(xb + L + i), az = __ldg(xb + 2 * L + i);
    const float bmi = __ldg(bm + i);
    const TT* trow = t + (size_t)il * L;
    const TT* wrow = w + (size_t)il * L;
    for (int j = lane; j < L; j += 32) {
      // every product and sum is spelled out (fmaf or a never-fused
      // intrinsic), so a row's bits do not depend on the rows beside it
      const float pv = __fmul_rn(bmi, __ldg(bm + j));
      const float pw = __fmul_rn(two_noe, __fmul_rn(c3d::tile_ldg(wrow + j), pv));  // 2 noe w pv
      const float pvn = (abs(i - j) >= 2) ? __fmul_rn(two_vdw, pv) : 0.f;   // 2 vdw nb
      const float dx = __fsub_rn(ax, __ldg(xb + j));
      const float dy = __fsub_rn(ay, __ldg(xb + L + j));
      const float dz = __fsub_rn(az, __ldg(xb + 2 * L + j));
      const float s = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, kEps)));
      const float rinv = c3d::rsqrt_fast(s);
      const float d = __fmul_rn(s, rinv);
      const float dev = __fsub_rn(d, c3d::tile_ldg(trow + j));
      const float ov = fmaxf(__fsub_rn(r0, d), 0.f);
      const float qn = __fmul_rn(pw, dev);    // 2 noe w pv dev
      const float qv = __fmul_rn(pvn, ov);    // 2 vdw nb ov
      v[3] = fmaf(qv, ov, fmaf(qn, dev, v[3]));
      const float cf = __fmul_rn(__fsub_rn(qn, qv), rinv);
      v[0] = fmaf(cf, dx, v[0]);
      v[1] = fmaf(cf, dy, v[1]);
      v[2] = fmaf(cf, dz, v[2]);
    }
  }
  int which;
  bool owner;
  c3d::fold_all_id<16, kVals>(lane, which, owner);
  c3d::fold_all<16>(v, lane);
  if (owner && which == 3) s_e[warp] = v[0];   // 0 for a row past the strip
  if (owner && which < 3 && row_in) gT[((size_t)b * 3 + which) * Lb + il] = v[0];
  __syncthreads();

  // the block's energy, its rows in order, then its ticket
  if (tid == 0) {
    float en = 0.f;
    for (int wq = 0; wq < kWarps; ++wq) en += s_e[wq];
    e_part[(size_t)b * gridDim.x + rg] = en;
    __threadfence();
    s_last = atomicAdd(ticket, 1) == (int)(gridDim.x * gridDim.y) - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: each structure's row groups in a fixed order (the sums
  // carry 2 noe and 2 vdw: e = 1/4 of them)
  last_block_row_sums(e_part, B, gridDim.x, s_stage, kStageMax,
                           [&](int bb, float val) { e[bb] = 0.25f * val; });
  if (tid == 0) *ticket = 0;
}

template <typename TT>
int launch_exact_pair(const float* xT, const TT* t, const TT* w, const float* bm,
                      float* gT, float* e, float* e_part, int* ticket, int B, int L,
                      int row0, int Lb, int n_per, float noe, float vdw, float vdw_radius,
                      void* stream) {
  if (row0 < 0 || Lb <= 0 || row0 + Lb > L || B <= 0 || n_per < 1 || B % n_per != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Lb + kWarps - 1) / kWarps, B);
  exact_pair_kernel<TT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      xT, t, w, bm, gT, e, e_part, ticket, B, L, row0, Lb, n_per, 2.f * noe,
      2.f * vdw, vdw_radius);
  return (int)cudaGetLastError();
}

}  // namespace

// B2 is row0 = 0, Lb = L; B2' a shard's rows [row0, row0 + Lb). B = C x
// n_per structures, chromosome-major, over C tile sets (C, Lb, L) and bead
// masks (C, L); C = 1 (n_per = B) is a batch sharing one restraint set. The
// grid is (ceil(Lb / 8), B); e_part: (B, ceil(Lb / 8)) scratch; ticket: one
// int that is 0 (each launch leaves it 0 again). The _bf16 entry takes
// bfloat16 t and w, everything else as the float32 one.
extern "C" int c3d_exact_pair(const float* xT, const float* t, const float* w,
                              const float* bm, float* gT, float* e, float* e_part,
                              int* ticket, int B, int L, int row0, int Lb, int n_per,
                              float noe, float vdw, float vdw_radius, void* stream) {
  return launch_exact_pair(xT, t, w, bm, gT, e, e_part, ticket, B, L, row0, Lb, n_per,
                           noe, vdw, vdw_radius, stream);
}

extern "C" int c3d_exact_pair_bf16(const float* xT, const __nv_bfloat16* t,
                                   const __nv_bfloat16* w, const float* bm, float* gT,
                                   float* e, float* e_part, int* ticket, int B, int L,
                                   int row0, int Lb, int n_per, float noe, float vdw,
                                   float vdw_radius, void* stream) {
  return launch_exact_pair(xT, t, w, bm, gT, e, e_part, ticket, B, L, row0, Lb, n_per,
                           noe, vdw, vdw_radius, stream);
}

extern "C" const char* c3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
