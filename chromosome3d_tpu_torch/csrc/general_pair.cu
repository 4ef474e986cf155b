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
//   e = 1/2 noe sum_ij wv well + 1/2 vdw sum_ij nb overlap^2
//   c_ij = (noe wv dwell sgn - 2 vdw nb overlap) * rinv
//   g_i = sum_j c_ij (x_i - x_j)
// The Pallas kernel forms g_i as x_i sum_j c_ij - (c @ X)_i; that cancels
// large float32 terms (ROADMAP §C), so the differences already in registers
// are summed instead, as B1-B3 do. The same finding rules the tensor cores
// out here (the only matrix form of the gradient is that product, and d^2
// from a Gram product loses ~1e-3 near contact): this is an FP32 CUDA-core
// kernel with one MUFU rsqrt per pair.
//
// What bounds it on an H100: instruction issue. B x Lb x L ordered pairs a
// call (524M at B = 20, L = 5120) at ~31 arithmetic instructions each, of
// which few fuse to FMAs, against 132 SMs x 128 lanes; the three (Lb, L)
// tiles (315 MB at L = 5120) move in a seventh of that time if they are
// read once per call. So the design spends as few instructions per pair
// beside the arithmetic as it can:
//  * a block of 8 warps takes 32 rows x one 128-column chunk (or a few
//    chunks in turn); a thread holds a 4 x 4 patch of lo, hi, 2 noe w pv and
//    2 vdw nb in registers (rows warp * 4 + a, columns lane + 32 k: every
//    tile load is one coalesced 128-byte line a warp), read from global
//    memory once and reused for all B structures;
//  * the chunk's coordinates of all B structures, and the block's rows', are
//    staged in shared memory by cp.async, the next chunk's while this one is
//    computed: the loop over structures reads 24 floats of shared memory for
//    16 pairs and touches no global memory;
//  * a warp owns its 4 rows over the whole chunk, so the only sum across
//    threads is over the warp's lanes: the 12 gradient sums and the energy
//    go through one multi-value butterfly (warp_fold.cuh, 15 shuffles) into
//    a warp-private shared-memory slot per structure, chunk after chunk;
//  * the grid is (row groups, column splits), enough blocks for every SM at
//    Lb = 1280 as at 5120; each block writes its rows' partial gradient for
//    its split and one energy per structure, and a second kernel adds the
//    splits in order. The split depends on L alone, so a row sees the same
//    columns in the same order whichever rows share the launch.
// No atomics: equal inputs give equal bits. Shared memory grows with the
// structures of a launch (the wrapper's batch slice, general_pair.py), not
// with L. The (B, 3, L) layout in and (B, 3, Lb) out feeds kernel B4 with no
// transposes.
//
// The chromosome axis (B5, and B5' on a genome group's strips): a genome
// bucket's C chromosomes of B structures each (the JAX runner's vmap of the
// solve over its bucket, or of the row block under its chrom x beads solve)
// in one launch per batch slice, grid z the chromosome over the same (row
// groups, splits) grid. The (C, L) bead masks are read at the global row
// row0 + il, the (C, Lb, L) strips at the strip row il. Chromosome c's blocks read its slice of
// structures, its tiles and its mask and write its partials at c's offsets;
// the plan (splits, slices) is a function of L and B, so each chromosome's
// blocks and sums are those of a launch of its own, and so are its bits.

#include <cuda_runtime.h>

#include "warp_fold.cuh"

namespace {

using c3d::kThreads;
using c3d::kWarps;

constexpr int kR = 4;                  // rows a warp (and a thread's patch)
constexpr int kC = 4;                  // columns a thread's patch
constexpr int kChunk = 32 * kC;        // columns a chunk
constexpr int kRowsBlock = kWarps * kR;
constexpr int kVals = 3 * kR + 1;      // a thread's sums per structure
constexpr float kEps = 1e-12f;

struct GeneralParams {
  int B, L, row0, Lb;     // structures of this launch, length, the strip
  int cps, nsplit;        // chunks a split, splits
  int Bc;                 // structures a chromosome (grid z), all slices
  float two_noe, two_vdw, r0, rs;
};

// floats of shared memory a block needs for B structures
__host__ __device__ constexpr int smem_floats(int B) {
  return B * (2 * 3 * kChunk + 3 * kRowsBlock + kWarps * kVals);
}

__global__ void __launch_bounds__(kThreads, 2)
general_pair_kernel(const float* __restrict__ xT,   // (C Bc, 3, L) from the slice
                    const float* __restrict__ lo,   // (C, Lb, L) rows row0..
                    const float* __restrict__ hi,   // (C, Lb, L)
                    const float* __restrict__ w,    // (C, Lb, L) mask * weight
                    const float* __restrict__ bm,   // (C, L) bead masks
                    float* __restrict__ part,       // (C Bc, nsplit, 3, Lb) out
                    float* __restrict__ e_part,     // (C Bc, row groups * nsplit) out
                    GeneralParams q) {
  extern __shared__ float smem[];
  const int B = q.B, L = q.L, Lb = q.Lb;
  // chromosome blockIdx.z: its structures, tiles, mask and partials
  const size_t chrom = blockIdx.z;
  xT += chrom * q.Bc * 3 * L;
  lo += chrom * Lb * L;
  hi += chrom * Lb * L;
  w += chrom * Lb * L;
  bm += chrom * L;
  part += chrom * q.Bc * q.nsplit * 3 * Lb;
  e_part += chrom * q.Bc * gridDim.x * gridDim.y;
  float* s_cols = smem;                          // [2][B][3][kChunk]
  float* s_rows = s_cols + 2 * B * 3 * kChunk;   // [B][3][kRowsBlock]
  float* s_slot = s_rows + B * 3 * kRowsBlock;   // [kWarps][B][kVals]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = blockIdx.x, sp = blockIdx.y;
  const int il0 = rg * kRowsBlock;               // the block's first strip row
  const int col_begin = sp * q.cps * kChunk;
  const int nchunk = min(q.cps, (L - col_begin + kChunk - 1) / kChunk);

  auto stage_cols = [&](int buf, int col0) {
    float* dst = s_cols + buf * B * 3 * kChunk;
    for (int idx = tid; idx < B * 3 * kChunk; idx += kThreads) {
      const int col = col0 + (idx % kChunk);
      const bool in = col < L;
      c3d::copy_async(dst + idx, xT + (size_t)(idx / kChunk) * L + (in ? col : 0), in);
    }
  };
  for (int idx = tid; idx < B * 3 * kRowsBlock; idx += kThreads) {
    const int il = il0 + (idx % kRowsBlock);
    const bool in = il < Lb;
    c3d::copy_async(s_rows + idx,
                    xT + (size_t)(idx / kRowsBlock) * L + (in ? q.row0 + il : 0), in);
  }
  stage_cols(0, col_begin);
  c3d::copy_async_commit();
  for (int idx = tid; idx < kWarps * B * kVals; idx += kThreads) s_slot[idx] = 0.f;

  int which;
  bool owner;
  c3d::fold_all_id<16, kVals>(lane, which, owner);
  float* my_slot = s_slot + (size_t)warp * B * kVals + which;

  const float rs = q.rs, two_rs = 2.f * q.rs, neg_rs_sq = -q.rs * q.rs, r0 = q.r0;
  for (int ch = 0; ch < nchunk; ++ch) {
    const int col0 = col_begin + ch * kChunk;
    // this thread's pairs: strip rows il0 + warp kR + a, columns col0 + lane
    // + 32 k; rows past the strip and columns past L hold nothing
    float plo[kR][kC], phi[kR][kC], pwn[kR][kC], pvn[kR][kC];
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      const int il = il0 + warp * kR + a;
      const int i = q.row0 + il;
      const float bmi = il < Lb ? bm[i] : 0.f;
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int j = col0 + lane + 32 * k;
        const bool in = il < Lb && j < L;
        const size_t idx = (size_t)il * L + j;
        const float pv = in ? bmi * bm[j] : 0.f;
        plo[a][k] = in ? lo[idx] : 0.f;
        phi[a][k] = in ? hi[idx] : 0.f;
        pwn[a][k] = in ? q.two_noe * (w[idx] * pv) : 0.f;
        pvn[a][k] = (abs(i - j) >= 2) ? q.two_vdw * pv : 0.f;
      }
    }
    // this chunk's coordinates have landed, and every warp is done with the
    // other buffer: the next chunk's may land there
    c3d::copy_async_wait<0>();
    __syncthreads();
    if (ch + 1 < nchunk) {
      stage_cols((ch + 1) & 1, col0 + kChunk);
      c3d::copy_async_commit();
    }
    const float* cols = s_cols + (ch & 1) * B * 3 * kChunk + lane;
    const float* rows = s_rows + warp * kR;

    for (int b = 0; b < B; ++b) {
      float ar[kR][3], xc[kC][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int a = 0; a < kR; ++a) ar[a][c] = rows[(b * 3 + c) * kRowsBlock + a];
#pragma unroll
        for (int k = 0; k < kC; ++k) xc[k][c] = cols[(b * 3 + c) * kChunk + 32 * k];
      }
      float v[kVals];
#pragma unroll
      for (int n = 0; n < kVals; ++n) v[n] = 0.f;
#pragma unroll
      for (int a = 0; a < kR; ++a) {
#pragma unroll
        for (int k = 0; k < kC; ++k) {
          // every product and sum is spelled out (fmaf or a never-fused
          // intrinsic): the compiler's own choice of which a * b + c to
          // fuse differs between the unrolled pairs, and a row's bits must
          // not depend on its slot a
          const float dx = ar[a][0] - xc[k][0];
          const float dy = ar[a][1] - xc[k][1];
          const float dz = ar[a][2] - xc[k][2];
          const float s = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, kEps)));
          const float rinv = c3d::rsqrt_fast(s);
          const float d = __fmul_rn(s, rinv);
          const float over = fmaxf(__fsub_rn(d, phi[a][k]), 0.f);
          const float under = fmaxf(__fsub_rn(plo[a][k], d), 0.f);
          const float viol = __fadd_rn(over, under);
          const float well =
              viol <= rs ? __fmul_rn(viol, viol) : fmaf(two_rs, viol, neg_rs_sq);
          // 1/2 dwell sgn: +-min(viol, rs), + where d is past hi
          const float m = fminf(viol, rs);
          const float sm = over > 0.f ? m : -m;
          const float ov = fmaxf(__fsub_rn(r0, d), 0.f);
          const float t = __fmul_rn(pvn[a][k], ov);
          v[3 * kR] = fmaf(t, ov, fmaf(pwn[a][k], well, v[3 * kR]));
          const float cf = __fmul_rn(fmaf(pwn[a][k], sm, -t), rinv);
          v[3 * a] = fmaf(cf, dx, v[3 * a]);
          v[3 * a + 1] = fmaf(cf, dy, v[3 * a + 1]);
          v[3 * a + 2] = fmaf(cf, dz, v[3 * a + 2]);
        }
      }
      c3d::fold_all<16>(v, lane);
      if (owner) my_slot[b * kVals] += v[0];
    }
  }
  __syncthreads();

  // the block's rows of this split, value a * 3 + c of warp r / kR
  for (int idx = tid; idx < B * 3 * kRowsBlock; idx += kThreads) {
    const int r = idx % kRowsBlock, bc = idx / kRowsBlock;
    const int b = bc / 3, c = bc - 3 * b;
    if (il0 + r < Lb)
      part[(((size_t)b * q.nsplit + sp) * 3 + c) * Lb + il0 + r] =
          s_slot[((r / kR) * B + b) * kVals + 3 * (r % kR) + c];
  }
  // the block's energy: the warps in order (scaled by the second kernel)
  for (int b = tid; b < B; b += kThreads) {
    float e = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) e += s_slot[(wi * B + b) * kVals + 3 * kR];
    e_part[(size_t)b * gridDim.x * gridDim.y + sp * gridDim.x + rg] = e;
  }
}

// gT[b, c, il] = the splits' partials in split order; e[b] = 1/4 of the
// blocks' energies (the patches carry 2 noe and 2 vdw), in a fixed order.
// b runs over all C Bc structures, chromosome-major.
__global__ void __launch_bounds__(kThreads)
general_reduce_kernel(const float* __restrict__ part,    // (C Bc, nsplit, 3, Lb)
                      const float* __restrict__ e_part,  // (C Bc, nblk)
                      float* __restrict__ gT,            // (C Bc, 3, Lb) out
                      float* __restrict__ e,             // (C Bc,) out
                      int Lb, int nsplit, int nblk) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx < 3 * Lb) {
    const float* pp = part + (size_t)b * nsplit * 3 * Lb + idx;
    float g = 0.f;
    for (int s = 0; s < nsplit; ++s) g += pp[(size_t)s * 3 * Lb];
    gT[(size_t)b * 3 * Lb + idx] = g;
  }
  if (blockIdx.x != 0) return;
  c3d::block_sum(e_part + (size_t)b * nblk, nblk, 0.25f, e + b);
}

}  // namespace

// B5 is row0 = 0, Lb = L; B5' a shard's rows [row0, row0 + Lb), for C >= 1.
// xT: (C B, 3, L), chromosome-major; lo, hi, w: (C, Lb, L); bm: (C, L).
// part: (C B, nsplit, 3, Lb) and e_part: (C B, ceil(Lb / 32) nsplit)
// scratch allocated by the caller, nsplit = ceil(ceil(L / 128) / cps); each
// chromosome's structures go through the pair kernel bslice at a time, one
// launch a slice for every chromosome. Chromosome c's outputs are bitwise
// those of a launch with C = 1 on its own inputs.
extern "C" int c3d_general_pair(const float* xT, const float* lo, const float* hi,
                                const float* w, const float* bm, float* part,
                                float* e_part, float* e, float* gT, int C, int B, int L,
                                int row0, int Lb, int cps, int bslice, float noe,
                                float vdw, float vdw_radius, float rswitch,
                                void* stream) {
  if (row0 < 0 || Lb <= 0 || row0 + Lb > L || cps <= 0 || bslice <= 0 || B <= 0 ||
      C <= 0 || C > 65535 || (long long)C * B > 65535)
    return (int)cudaErrorInvalidValue;
  const int nchunks = (L + kChunk - 1) / kChunk;
  const int nsplit = (nchunks + cps - 1) / cps;
  const int groups = (Lb + kRowsBlock - 1) / kRowsBlock;
  const int nblk = groups * nsplit;
  cudaStream_t st = (cudaStream_t)stream;
  // past the 227 KB a block can opt into, the attribute call fails and the
  // wrapper raises
  const size_t smem = (size_t)smem_floats(min(bslice, B)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      general_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < B; b0 += bslice) {
    const int Bl = min(bslice, B - b0);
    const GeneralParams q{Bl, L, row0, Lb, cps, nsplit, B,
                          2.f * noe, 2.f * vdw, vdw_radius, rswitch};
    general_pair_kernel<<<dim3(groups, nsplit, C), kThreads,
                          (size_t)smem_floats(Bl) * sizeof(float), st>>>(
        xT + (size_t)b0 * 3 * L, lo, hi, w, bm,
        part + (size_t)b0 * nsplit * 3 * Lb, e_part + (size_t)b0 * nblk, q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((3 * Lb + kThreads - 1) / kThreads, C * B);
  general_reduce_kernel<<<grid, kThreads, 0, st>>>(part, e_part, gT, e, Lb, nsplit, nblk);
  return (int)cudaGetLastError();
}
