// Kernel B4: the update half of an annealing step, given a pair gradient
// made by another kernel — chain bond, per-bead clip, Adam with the bias
// corrections of the schedule, CLT-4 Langevin noise and the coordinate move
// — for the step a device counter holds, with that step's history row.
//
// Replaces: chromosome3d_tpu/ops/pallas_energy.py `_kernel_fused_update`
// (entry `pallas_fused_update_batched`). On the port's semi routes it runs
// every step after the pair kernel (B3, B5, or B6 / B5' / B2' per shard) has
// formed the pair gradient: B = 20 then 10 structures at L = 5120 or 512.
// On the genome path past the length buckets it runs once a step for the
// whole bucket: C chromosomes of n structures, a bead mask and a noise seed
// a chromosome (read from a (C,) device array), structure b of the launch
// being structure b mod n of chromosome b / n. The noise hash takes that
// index within its chromosome, so each chromosome's bits are those of a
// launch of its own; the step, the table row and the history row
// (structure b's column) are shared.
//
// One launch a step does all of the step's work outside the pair kernel:
//  * its scalars come from the device: the step k = *step (a counter the
//    caller sets once a phase), lr, sigma, bc1 and bc2 from row k - first of
//    the schedule table (the rows B1 reads, columns kTableCols); the solve's
//    constants come by value. The noise stream's step is the same k. A k
//    outside the table's rows stops the kernel (a trap) before it reads
//    the table or writes the history.
//  * it writes hist[k - first, b] = e_pair[b] + the bond energies of
//    structure b, summed in a fixed order by a cluster of 4 blocks of its
//    own (below). No float atomics: two calls on equal inputs give equal
//    bits.
//  * thread 0 of every block reads k with an acquire load and then draws a
//    ticket (one atomic counter); the block that draws the last one knows
//    every block has read k, and when it ends it moves the counter to k + 1
//    and sets the ticket back to 0 for the next launch. No block waits on
//    another's ticket.
// The per-bead math is step_common.cuh's `bond_forward`, `clip_scale`,
// `adam_move` and noise, composed as B1's update composes them, so B4's
// bond, update and noise are B1's by construction.
//
// What bounds it on an H100: latency. Per bead ~60 FP32 operations, three
// sqrt and ~60 integer operations of noise hashing, and 14 floats of state
// read or written (x with its two neighbours, g, mu, nu in; x', mu', nu'
// out): at B = 20, L = 5120 about 6 MB a step, which the L2 holds, against
// a chain of dependent loads. The grid is (4 + ceil(L / 256) rounded up to
// a multiple of 4, B) in clusters of 4 along x:
//  * blocks 4.. are the bead blocks, one thread a (bead, structure), 256
//    beads of one structure a block (at L = 5120, B = 20: 480 blocks, one
//    wave of 4 an SM at 64 registers); every thread issues all of its 13
//    loads (x, g, mu and nu of its three coordinates, its bead mask; the
//    warp's two end lanes also the halo bead) before any arithmetic, and
//    the step's table row as soon as k has arrived; the neighbour beads
//    come from the lanes beside by warp shuffles. Outputs go to separate
//    buffers (each bead reads its neighbours' old x), never in place.
//  * blocks 0-3 of structure b, one cluster, recompute its L - 1 bond
//    energies with `bond_forward` from the launch's input x (which no block
//    writes), a quarter each, with every load of a thread's 5 beads issued
//    first; each sums its quarter in a fixed order (a thread's beads in
//    order, the warp's lanes over a butterfly, the warps in order); after a
//    cluster barrier block 0 adds the four sums in rank order from the
//    others' shared memory and writes the history row. They run beside the
//    bead blocks, so the row costs no tail after them.
// (A last-block ticket summing every block's energy, one extra block a
// structure, and a thread a (bead, coordinate) were slower:
// scripts/variant_probe_torch.py, PERF.md §6.)

#include "step_common.cuh"
#include "warp_fold.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

using c3d::kThreads;                    // beads a bead block, of one structure
using c3d::kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEBlocks = 4;             // energy blocks a structure: one cluster
constexpr int kBatch = 5;               // beads an energy-block thread loads at once
constexpr int kMinBlocks = 4;           // blocks an SM the registers leave room for

struct UpdateConsts {
  int B, n, L, first, rows, hist_stride;   // B = C n structures, n a chromosome
  float b1, b2, eps_adam, bond_w, bond_len, clip;
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// the energies of structure xb's bonds from beads [i0, i1), summed in a
// fixed order; the result is in thread 0. Called by every thread of the
// block.
__device__ __forceinline__ float bond_energy_sum(const float* __restrict__ xb,
                                                 const float* __restrict__ bm, int L,
                                                 int i0, int i1, const c3d::StepParams& p,
                                                 float* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float e = 0.f;
  for (int r0 = i0; r0 < i1; r0 += kThreads * kBatch) {
    float a[kBatch][3], h[kBatch][3], bmi[kBatch], bmh[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      // bead i's successor is the next lane's bead (lane 31: a halo load),
      // loaded past the quarter's end too
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
      if (i < i1 && i + 1 < L) e += c3d::bond_forward(a[r], nx, bmi[r] * bmn, p, fwd);
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

__global__ void __cluster_dims__(kEBlocks, 1, 1) __launch_bounds__(kThreads, kMinBlocks)
fused_update_kernel(const float* __restrict__ xT,     // (B, 3, L)
                    const float* __restrict__ gT,     // (B, 3, L) pair gradient
                    const float* __restrict__ muT,    // (B, 3, L)
                    const float* __restrict__ nuT,    // (B, 3, L)
                    const float* __restrict__ bm,     // (C, L) bead masks
                    const int* __restrict__ seeds,    // (C,) noise seeds
                    const float* __restrict__ e_pair, // (B,) pair energies
                    const float* __restrict__ table,  // (rows, kTableCols)
                    int* __restrict__ step,           // the step k
                    float* __restrict__ hist,         // row k - first, B floats
                    int* __restrict__ ticket,         // 0 between launches
                    float* __restrict__ xTo, float* __restrict__ muTo,
                    float* __restrict__ nuTo,         // (B, 3, L) out
                    UpdateConsts q) {
  __shared__ float s_warp[kWarps];
  __shared__ float s_sum;
  __shared__ int s_k;
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.y, L = q.L;
  // structure b is structure bl of chromosome c: its mask and seed are the
  // chromosome's, and its noise stream is bl's, as in a launch of its own
  const int c = b / q.n, bl = b - c * q.n;
  bm += (size_t)c * L;
  const bool energy = blockIdx.x < kEBlocks;
  const int i = ((int)blockIdx.x - kEBlocks) * kThreads + tid;
  const bool live = !energy && i < L;
  const size_t at = (size_t)b * 3 * L + i;

  // every state load before any arithmetic; x, g, mu and nu were written by
  // the kernels before this one, so they are read through L2
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
  const float ep = blockIdx.x == 0 && tid == 0 ? __ldg(e_pair + b) : 0.f;
  // k, then this block's ticket: the acquire orders the ticket after the
  // read, so the block with the last ticket may move the counter on
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
  p.vdw = 0.f;          // the pair terms' columns: not B4's
  p.vdw_radius = 0.f;
  p.b1 = q.b1;
  p.b2 = q.b2;
  p.eps_adam = q.eps_adam;
  p.bond_w = q.bond_w;
  p.bond_len = q.bond_len;
  p.clip = q.clip;
  p.step = (uint32_t)k;
  if (energy) {
    // this block's quarter of the structure's bonds, then block 0 adds the
    // cluster's four sums in rank order
    p.lr = p.sigma = p.bc1 = p.bc2 = 0.f;
    const int span = (L + kEBlocks - 1) / kEBlocks, i0 = (int)blockIdx.x * span;
    const float eb = bond_energy_sum(xT + (size_t)b * 3 * L, bm, L, i0, min(L, i0 + span), p,
                                     s_warp);
    if (tid == 0) s_sum = eb;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (blockIdx.x == 0 && tid == 0) {
      float t = 0.f;
      for (int r = 0; r < kEBlocks; ++r) t += *cluster.map_shared_rank(&s_sum, r);
      hist[(size_t)(k - q.first) * q.hist_stride + b] = ep + t;
    }
    cluster.sync();   // the others' shared memory stays until block 0 has read it
  } else {
    const float* row = table + (size_t)(k - q.first) * c3d::kTableCols;
    p.seed = (uint32_t)__ldg(seeds + c);
    p.lr = __ldg(row + 0);
    p.sigma = __ldg(row + 1);
    p.bc1 = __ldg(row + 4);
    p.bc2 = __ldg(row + 5);
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
    if (i + 1 < L) c3d::bond_forward(a, nx, bmi * bmn, p, fwd);
    if (i > 0) c3d::bond_forward(pv, a, bmp * bmi, p, fwd_prev);
    float gr[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) gr[c] = g0[c] + (fwd_prev[c] - fwd[c]);
    const float scale = c3d::clip_scale(gr, p);
    const uint32_t base = c3d::noise_base(p, bl);
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

// ticket: one int that is 0 (each launch leaves it 0 again); table: the
// schedule's `rows` rows, row k - first for step k = *step; hist: row
// k - first of a (rows, hist_stride) buffer; bm: (B / n, L) bead masks and
// seeds: (B / n,) noise seeds, one a chromosome of n structures.
extern "C" int c3d_fused_update(const float* xT, const float* gT, const float* muT,
                                const float* nuT, const float* bm, const int* seeds,
                                const float* e_pair, const float* table, int* step,
                                float* hist, int* ticket, float* xTo, float* muTo,
                                float* nuTo, int B, int n, int L, int first, int rows,
                                int hist_stride, float b1, float b2, float eps_adam,
                                float bond_w, float bond_len, float clip, void* stream) {
  if (B <= 0 || n <= 0 || B % n || L <= 0 || rows <= 0 || hist_stride < B)
    return (int)cudaErrorInvalidValue;
  const UpdateConsts q{B, n, L, first, rows, hist_stride, b1, b2, eps_adam, bond_w,
                       bond_len, clip};
  const int nx = kEBlocks + (L + kThreads - 1) / kThreads;
  const dim3 grid((nx + kEBlocks - 1) / kEBlocks * kEBlocks, B);
  fused_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      xT, gT, muT, nuT, bm, seeds, e_pair, table, step, hist, ticket, xTo, muTo, nuTo, q);
  return (int)cudaGetLastError();
}
