// Kernel B4 as first redesigned for the H100 (kept to time it against the
// shipped csrc/fused_update.cu): one thread a (bead, structure), each block
// writing its beads' bond-energy sum, and the last block to arrive (a
// ticket, after a fence) adding every structure's block sums in index order
// for the history row and moving the counter on. Entry
// c3d_fused_update_ticket, with the shipped entry's arguments; the block
// sums go to a scratch array of its own.
//
// Its description as it was shipped:
//
// Kernel B4: the update half of an annealing step, given a pair gradient
// made by another kernel — chain bond, per-bead clip, Adam with the bias
// corrections of the schedule, CLT-4 Langevin noise and the coordinate move
// — for the step a device counter holds, with that step's history row.
//
// Replaces: chromosome3d_tpu/ops/pallas_energy.py `_kernel_fused_update`
// (entry `pallas_fused_update_batched`). On the port's semi routes it runs
// every step after the pair kernel (B3, B5, or B6 / B5' / B2' per shard) has
// formed the pair gradient: B = 20 then 10 structures at L = 5120 or 512.
//
// One launch a step does all of the step's work outside the pair kernel:
//  * its scalars come from the device: the step k = *step (a counter the
//    caller sets once a phase), lr, sigma, bc1 and bc2 from row k - first of
//    the schedule table (the rows B1 reads, columns kTableCols); the solve's
//    constants come by value. The noise stream's step is the same k.
//  * it writes hist[k - first, b] = e_pair[b] + the bond energies of
//    structure b, summed in a fixed order: each block writes its beads' sum,
//    and the last block to arrive (a ticket: one atomic counter, no float
//    atomics) adds every structure's block sums in index order. Two calls on
//    equal inputs give equal bits.
//  * the last block, when every block has read k, advances the counter to
//    k + 1 and sets the ticket back to 0 for the next launch.
// The per-bead math is step_common.cuh's `bond_forward`, `clip_scale`,
// `adam_move` and noise, composed as B1's update composes them, so B4's
// bond, update and noise are B1's by construction.
//
// What bounds it on an H100: latency. Per bead ~60 FP32 operations, three
// sqrt and ~60 integer operations of noise hashing, and 14 floats of state
// read or written (x with its two neighbours, g, mu, nu in; x', mu', nu'
// out): at B = 20, L = 5120 about 6 MB a step, which the L2 holds, against
// a chain of dependent loads. So: one thread a (bead, structure), 256 beads
// of one structure a block, which at that shape is 400 blocks, one wave on
// 132 SMs; every thread issues all of its 13 loads (x, g, mu and nu of its
// three coordinates, its bead mask; the warp's two end lanes also the halo
// bead) before any arithmetic, and the step's table row as soon as k has
// arrived, while the bond and the noise are computed; the neighbour beads
// come from the lanes beside by warp shuffles. (One thread a coordinate, 10
// beads a warp, was tried: 3.2 times the threads made it two waves, and
// slower.) Outputs go to separate buffers (each bead reads its neighbours'
// old x), never in place.

#include "step_common.cuh"
#include "warp_fold.cuh"

namespace {

using c3d::kThreads;                          // beads a block, of one structure
using c3d::kWarps;
constexpr int kStageMax = 2048;               // partials the last block stages
constexpr unsigned kFull = 0xffffffffu;

struct UpdateConsts {
  int B, L, first, hist_stride;
  float b1, b2, eps_adam, bond_w, bond_len, clip;
  uint32_t seed;
};

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
fused_update_kernel(const float* __restrict__ xT,     // (B, 3, L)
                    const float* __restrict__ gT,     // (B, 3, L) pair gradient
                    const float* __restrict__ muT,    // (B, 3, L)
                    const float* __restrict__ nuT,    // (B, 3, L)
                    const float* __restrict__ bm,     // (L,) bead mask
                    const float* __restrict__ e_pair, // (B,) pair energies
                    const float* __restrict__ table,  // (rows, kTableCols)
                    int* __restrict__ step,           // the step k
                    float* __restrict__ hist,         // row k - first, B floats
                    float* __restrict__ part,         // (B, blocks a structure)
                    int* __restrict__ ticket,         // 0 between launches
                    float* __restrict__ xTo, float* __restrict__ muTo,
                    float* __restrict__ nuTo,         // (B, 3, L) out
                    UpdateConsts q) {
  __shared__ float s_warp[kWarps];
  __shared__ float s_part[kStageMax];
  __shared__ float s_epair[kThreads];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, L = q.L;
  const int i = blockIdx.x * kThreads + tid;
  const bool live = i < L;
  const size_t at = (size_t)b * 3 * L + i;

  // every load before any arithmetic; x, g, mu and nu were written by the
  // kernels before this one, so they are read through L2. The pair energies
  // are for the history row, which only the last block writes, but their
  // load is in flight with the rest.
  const int k = __ldcg(step);
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
    // the warp's end lanes load the halo: bead i - 1 for lane 0, i + 1 for 31
    const int h = lane == 0 ? i - 1 : i + 1;
    if ((lane == 0 || lane == 31) && h >= 0 && h < L) {
#pragma unroll
      for (int c = 0; c < 3; ++c) halo[c] = __ldcg(xT + at + (size_t)c * L + (h - i));
      bmh = __ldg(bm + h);
    }
  }
  if (tid < q.B) s_epair[tid] = __ldg(e_pair + tid);
  const float* row = table + (size_t)(k - q.first) * c3d::kTableCols;
  c3d::StepParams p;
  p.lr = __ldg(row + 0);
  p.sigma = __ldg(row + 1);
  p.vdw = 0.f;          // the pair terms' columns: not B4's
  p.vdw_radius = 0.f;
  p.bc1 = __ldg(row + 4);
  p.bc2 = __ldg(row + 5);
  p.b1 = q.b1;
  p.b2 = q.b2;
  p.eps_adam = q.eps_adam;
  p.bond_w = q.bond_w;
  p.bond_len = q.bond_len;
  p.clip = q.clip;
  p.seed = q.seed;
  p.step = (uint32_t)k;

  // the neighbour beads from the lanes beside this one, or the halo
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

  // B1's update, fused_steps.cu: the bond from the old x, the clip, then
  // Adam and the noisy move of each coordinate
  float fwd[3] = {0.f, 0.f, 0.f}, fwd_prev[3] = {0.f, 0.f, 0.f};
  float e_bond = 0.f;
  if (i + 1 < L) e_bond = c3d::bond_forward(a, nx, bmi * bmn, p, fwd);
  if (i > 0) c3d::bond_forward(pv, a, bmp * bmi, p, fwd_prev);
  float gr[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) gr[c] = g0[c] + (fwd_prev[c] - fwd[c]);
  const float scale = c3d::clip_scale(gr, p);
  float xo[3];
  const uint32_t base = c3d::noise_base(p, b);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float g = gr[c];
    if (p.clip > 0.f) g = g * scale;
    xo[c] = c3d::adam_move(a[c], g, mu[c], nu[c], bmi, (uint32_t)(i * 3 + c), base, p);
  }

  // the block's bond energy: its beads over a fixed tree, the warps in order
  float e = live ? e_bond : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(kFull, e, off);
  if (lane == 0) s_warp[warp] = e;
  __syncthreads();
  const int nblk = gridDim.x, n = q.B * nblk;
  if (tid == 0) {
    float eb = 0.f;
    for (int wq = 0; wq < kWarps; ++wq) eb += s_warp[wq];
    part[(size_t)b * nblk + blockIdx.x] = eb;
    __threadfence();
    s_last = atomicAdd(ticket, 1) == n - 1;
  }
  // the new state goes out while the ticket is in flight (the fence above
  // waits for the block's energy alone)
  if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xTo[at + (size_t)c * L] = xo[c];
      muTo[at + (size_t)c * L] = mu[c];
      nuTo[at + (size_t)c * L] = nu[c];
    }
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: every structure's block sums in a fixed order, then
  // the counter moves on (every block has read k)
  last_block_row_sums(part, q.B, nblk, s_part, kStageMax, [&](int bb, float v) {
    const float ep = bb < kThreads ? s_epair[bb] : __ldg(e_pair + bb);
    hist[(size_t)(k - q.first) * q.hist_stride + bb] = ep + v;
  });
  if (tid == 0) {
    *step = k + 1;
    *ticket = 0;
  }
}

}  // namespace

__device__ float g_part[4096];   // (B, blocks a structure) block sums

extern "C" int c3d_fused_update_ticket(const float* xT, const float* gT, const float* muT,
                                       const float* nuT, const float* bm,
                                       const float* e_pair, const float* table, int* step,
                                       float* hist, int* ticket, float* xTo, float* muTo,
                                       float* nuTo, int B, int L, int first, int rows,
                                       int hist_stride, float b1, float b2, float eps_adam,
                                       float bond_w, float bond_len, float clip, int seed,
                                       void* stream) {
  const int nblk = (L + kThreads - 1) / kThreads;
  if (B <= 0 || L <= 0 || rows <= 0 || hist_stride < B || B * nblk > 4096)
    return (int)cudaErrorInvalidValue;
  float* part = nullptr;
  cudaError_t err = cudaGetSymbolAddress((void**)&part, g_part);
  if (err != cudaSuccess) return (int)err;
  const UpdateConsts q{B, L, first, hist_stride, b1, b2, eps_adam, bond_w, bond_len,
                       clip, (uint32_t)seed};
  const dim3 grid(nblk, B);
  fused_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      xT, gT, muT, nuT, bm, e_pair, table, step, hist, part, ticket, xTo, muTo, nuTo, q);
  return (int)cudaGetLastError();
}
