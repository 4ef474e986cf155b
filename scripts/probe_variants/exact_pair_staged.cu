// Kernel B2/B2' as first redesigned for the H100 (kept to time it against
// the shipped csrc/exact_pair.cu): a warp a row over 512-column chunks, a
// lane's t, 2 noe w pv and 2 vdw nb in registers reused for a slice of sg
// structures, the chunk's coordinates staged by cp.async, the grid (row
// groups, structure groups) one wave, the energies summed by a last-block
// ticket. Entry c3d_exact_pair_staged, with the shipped entry's arguments;
// it picks sg itself, by the rule its host plan used.
//
// Its description as it was shipped:
//
// Kernel B2: exact-restraint pair energy and gradient for a batch of
// structures sharing one restraint set.
//
// Replaces: chromosome3d_tpu/ops/pallas_energy.py `_kernel_exact`, reached
// through `_pairwise_energy_grad_batched(..., exact=True)` (B2: all L rows)
// and through `pallas_row_block_energy_grad_batched(..., exact=True)` (B2':
// the Lb rows [row0, row0 + Lb) of one shard of the row-sharded solve, from
// (Lb, L) strips of the tiles; one body, so B2' rows are bitwise B2's). On
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
// What bounds it on an H100: at the shapes it runs, latency, and how much
// of the card it fills. B x Lb x L pairs (5.2M at the pick, 1.3-2.6M a shard
// step) at ~23 instructions each are 1-4 us of issue on 132 SMs; the (Lb,
// L) tiles are 0.5-1 MiB, in L2, but read once per structure they would be
// 10-40 MB of L2 traffic. The design:
//  * a warp owns one row over all L columns, so a row's gradient never
//    leaves its warp: a block of 8 warps takes 8 rows for a slice of sg
//    structures, grid (row groups, structure groups), which at those shapes
//    is 256-320 blocks, up to three an SM (80 registers a thread);
//  * a lane holds its columns' t, 2 noe w pv and 2 vdw nb of the row (16
//    of each a 512-column chunk) in registers, loaded once and reused for
//    every structure of the slice, so the tiles are read once per slice;
//  * the chunk's coordinates of the slice and its bead mask are staged in
//    shared memory by cp.async, issued before the tile loads, so both are
//    in flight together; the loop over structures touches no global memory;
//  * per structure the lane's 3 gradient sums and its energy go through
//    one multi-value butterfly (warp_fold.cuh, 6 shuffles); the lanes that
//    own them add them into the warp's slot, chunk after chunk, and write
//    the (B, 3, Lb) gradient rows at the end;
//  * each block writes its rows' energy per structure, and the last block
//    to arrive (a ticket: one atomic counter) adds them in a fixed order
//    into e (B,). The grid is one wave (ops/pair_energy.py
//    `exact_pair_plan`): a block holds its slot until its ticket returns,
//    so a second wave would wait for the first one's tickets.
// A row's columns are chunked by L alone and summed in the same order
// whichever rows share the launch, and every product and sum is spelled as
// fmaf or a never-fused intrinsic, so B2' rows are B2's bits. No float
// atomics: equal inputs give equal bits.

#include <cuda_runtime.h>

#include "warp_fold.cuh"

namespace {

using c3d::kThreads;
using c3d::kWarps;

constexpr int kChunk = 512;            // columns staged at a time
constexpr int kCpl = kChunk / 32;      // a lane's columns of a chunk
constexpr int kVals = 4;               // a lane's sums per structure
constexpr float kEps = 1e-12f;

struct ExactParams {
  int B, L, row0, Lb;     // structures, length, the strip
  int sg;                 // structures a block
  float two_noe, two_vdw, r0;
};

// floats of shared memory a block needs for sg structures: the chunk's
// coordinates and bead mask, the rows' coordinates, the warps' slots
__host__ __device__ constexpr int smem_floats(int sg) {
  return sg * 3 * kChunk + kChunk + sg * 3 * kWarps + kWarps * sg * kVals;
}

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

__global__ void __launch_bounds__(kThreads)
exact_pair_kernel(const float* __restrict__ xT,   // (B, 3, L)
                  const float* __restrict__ t,    // (Lb, L) targets, rows row0..
                  const float* __restrict__ w,    // (Lb, L) folded weights
                  const float* __restrict__ bm,   // (L,) bead mask
                  float* __restrict__ gT,         // (B, 3, Lb) out
                  float* __restrict__ e,          // (B,) out
                  float* __restrict__ e_part,     // (B, row groups) scratch
                  int* __restrict__ ticket,       // 0 between launches
                  ExactParams q) {
  extern __shared__ float smem[];
  __shared__ int s_last;
  const int L = q.L, Lb = q.Lb, sg = q.sg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = blockIdx.x, b0 = blockIdx.y * sg, nb = min(sg, q.B - b0);
  const int il0 = rg * kWarps, il = il0 + warp, i = q.row0 + il;   // the warp's row
  const bool row_in = il < Lb;
  float* s_x = smem;                          // [sg][3][kChunk]
  float* s_bm = s_x + sg * 3 * kChunk;        // [kChunk]
  float* s_rows = s_bm + kChunk;              // [sg][3][kWarps]
  float* s_slot = s_rows + sg * 3 * kWarps;   // [kWarps][sg][kVals]
  const float* xb = xT + (size_t)b0 * 3 * L;

  for (int idx = tid; idx < nb * 3 * kWarps; idx += kThreads) {
    const int r = il0 + idx % kWarps;
    const bool in = r < Lb;
    c3d::copy_async(s_rows + idx, xb + (size_t)(idx / kWarps) * L + (in ? q.row0 + r : 0), in);
  }
  for (int idx = tid; idx < kWarps * sg * kVals; idx += kThreads) s_slot[idx] = 0.f;
  int which;
  bool owner;
  c3d::fold_all_id<16, kVals>(lane, which, owner);
  float* my_slot = s_slot + (size_t)warp * sg * kVals + which;
  const float bmi = row_in ? __ldg(bm + i) : 0.f;
  const float r0 = q.r0;

  for (int c0 = 0; c0 < L; c0 += kChunk) {
    if (c0 > 0) __syncthreads();   // every warp is done with the last chunk
    // the chunk's coordinates and bead mask, in flight with the tile loads
    for (int idx = tid; idx < (3 * nb + 1) * kChunk; idx += kThreads) {
      const int r = idx / kChunk, col = c0 + (idx - r * kChunk);
      const bool in = col < L;
      const float* src = r < 3 * nb ? xb + (size_t)r * L : bm;
      float* dst = r < 3 * nb ? s_x + idx : s_bm + (idx - r * kChunk);
      c3d::copy_async(dst, src + (in ? col : 0), in);
    }
    c3d::copy_async_commit();
    // this lane's pairs: row i, columns c0 + lane + 32 m; a row past the
    // strip or a column past L holds nothing (bead 0)
    float pt[kCpl], pw[kCpl];
#pragma unroll
    for (int m = 0; m < kCpl; ++m) {
      const int j = c0 + lane + 32 * m;
      const bool in = row_in && j < L;
      const size_t idx = (size_t)il * L + j;
      pt[m] = in ? __ldg(t + idx) : 0.f;
      pw[m] = in ? __ldg(w + idx) : 0.f;
    }
    c3d::copy_async_wait<0>();
    __syncthreads();
    float pvn[kCpl];
#pragma unroll
    for (int m = 0; m < kCpl; ++m) {
      const int j = c0 + lane + 32 * m;
      const float pv = __fmul_rn(bmi, s_bm[lane + 32 * m]);
      pw[m] = __fmul_rn(q.two_noe, __fmul_rn(pw[m], pv));     // 2 noe w pv
      pvn[m] = (abs(i - j) >= 2) ? __fmul_rn(q.two_vdw, pv) : 0.f;
    }

    for (int b = 0; b < nb; ++b) {
      const float* xs = s_x + (size_t)b * 3 * kChunk + lane;
      const float* xr = s_rows + (size_t)b * 3 * kWarps + warp;
      const float ax = xr[0], ay = xr[kWarps], az = xr[2 * kWarps];
      float v[kVals] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < kCpl; ++m) {
        // every product and sum is spelled out (fmaf or a never-fused
        // intrinsic), so a row's bits do not depend on the rows beside it
        const float dx = __fsub_rn(ax, xs[32 * m]);
        const float dy = __fsub_rn(ay, xs[kChunk + 32 * m]);
        const float dz = __fsub_rn(az, xs[2 * kChunk + 32 * m]);
        const float s = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, kEps)));
        const float rinv = c3d::rsqrt_fast(s);
        const float d = __fmul_rn(s, rinv);
        const float dev = __fsub_rn(d, pt[m]);
        const float ov = fmaxf(__fsub_rn(r0, d), 0.f);
        const float qn = __fmul_rn(pw[m], dev);    // 2 noe w pv dev
        const float qv = __fmul_rn(pvn[m], ov);    // 2 vdw nb ov
        v[3] = fmaf(qv, ov, fmaf(qn, dev, v[3]));
        const float cf = __fmul_rn(__fsub_rn(qn, qv), rinv);
        v[0] = fmaf(cf, dx, v[0]);
        v[1] = fmaf(cf, dy, v[1]);
        v[2] = fmaf(cf, dz, v[2]);
      }
      c3d::fold_all<16>(v, lane);
      if (owner) my_slot[b * kVals] += v[0];
    }
  }
  __syncthreads();

  // the block's energy of each structure, rows in order, then its ticket;
  // the warps' gradient rows go out while the ticket is in flight (the
  // fence waits for the energies alone)
  if (tid < nb) {
    float en = 0.f;
    for (int wq = 0; wq < kWarps; ++wq) en += s_slot[(wq * sg + tid) * kVals + 3];
    e_part[(size_t)(b0 + tid) * gridDim.x + rg] = en;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1) == (int)(gridDim.x * gridDim.y) - 1;
  if (owner && which < 3 && row_in)
    for (int b = 0; b < nb; ++b)
      gT[((size_t)(b0 + b) * 3 + which) * Lb + il] = my_slot[b * kVals];
  __syncthreads();
  if (!s_last) return;

  // the last block: each structure's row groups in a fixed order (the
  // slots carry 2 noe and 2 vdw: e = 1/4 of the sum)
  last_block_row_sums(e_part, q.B, gridDim.x, s_x, sg * 3 * kChunk,
                           [&](int b, float v) { e[b] = 0.25f * v; });
  if (tid == 0) *ticket = 0;
}

}  // namespace

// the slice the host plan picked: among the grids of one wave (3 blocks an
// SM) that give every SM a block, the least work on the busiest SM,
// ceil(blocks / n_sm) x sg; ties to the smaller slice
static int pick_slice(int B, int Lb, int n_sm) {
  const int groups = (Lb + kWarps - 1) / kWarps;
  int best = 1;
  long best_key[4] = {0, 0, 0, 0};
  for (int sg = 1; sg <= (B < 8 ? B : 8); ++sg) {
    const long blocks = (long)groups * ((B + sg - 1) / sg);
    const long key[4] = {blocks > 3L * n_sm, blocks < n_sm, (blocks + n_sm - 1) / n_sm * sg, sg};
    bool less = sg == 1;
    for (int m = 0; m < 4 && !less; ++m) {
      if (key[m] != best_key[m]) {
        less = key[m] < best_key[m];
        break;
      }
    }
    if (less) {
      best = sg;
      for (int m = 0; m < 4; ++m) best_key[m] = key[m];
    }
  }
  return best;
}

extern "C" int c3d_exact_pair_staged(const float* xT, const float* t, const float* w,
                                     const float* bm, float* gT, float* e, float* e_part,
                                     int* ticket, int B, int L, int row0, int Lb, float noe,
                                     float vdw, float vdw_radius, void* stream) {
  if (row0 < 0 || Lb <= 0 || row0 + Lb > L || B <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int sg = pick_slice(B, Lb, n_sm);
  const ExactParams q{B, L, row0, Lb, sg, 2.f * noe, 2.f * vdw, vdw_radius};
  const size_t smem = (size_t)smem_floats(sg) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      exact_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lb + kWarps - 1) / kWarps, (B + sg - 1) / sg);
  exact_pair_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      xT, t, w, bm, gT, e, e_part, ticket, q);
  return (int)cudaGetLastError();
}
