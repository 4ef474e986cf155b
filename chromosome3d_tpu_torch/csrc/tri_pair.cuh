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
// pair's force is summed over the differences already in registers. That
// also rules the tensor cores out (those products are the only matrix form
// of the gradient, and d^2 from a Gram product loses ~1e-3 near contact):
// an FP32 CUDA-core body with one MUFU rsqrt per pair (`pair_step`, the one
// spelling of the math every body uses).
//
// What bounds it on an H100: instruction issue, 22 FP32 instructions and one
// MUFU rsqrt per unordered pair against 132 SMs x 128 lanes, and around them
// what a thread spends on each structure: folding its row and column sums
// over the lanes that share its rows or columns, loading coordinates,
// storing sums. The (Tl TM, L) tiles are read once a call and move in a
// fraction of that time. A thread keeps its patch of the tile (t, 2 noe w
// pv, 2 vdw nb) in registers, loaded once and reused for all B structures:
// 48 registers at 4 x 4 pairs, as large as a patch gets at two blocks of 256
// threads an SM (128 registers a thread). Larger patches with the tile in
// shared memory instead (scripts/probe_variants/tri_pair_staged.cuh: 8 x 4
// and 8 x 8 pairs a lane, half the fold values a pair) were slower on the
// card at every shape the paths run: reading the tile from shared memory
// costs more than the folds it saves (PERF.md §6).
//
// Both bodies: one block of 256 threads (16 x 16) per (tile, shell). The
// structures go through in slices of BS: the row and column tiles'
// coordinates of a slice are staged in shared memory by cp.async, the next
// slice's while this one is computed, so the loop over structures reads no
// global memory. Inside that loop nothing crosses a warp: a warp owns
// 2 x kPer rows over all TM columns, so the row sums (and the energy) finish
// in a multi-value butterfly over each half-warp (warp_fold.cuh: 13 values
// in 4 stages at kPer = 4) and land in shared memory; the column sums fold
// once over the two half-warps and land in a per-warp slot of every
// structure of the slice. No barrier in the loop; one after it, then every
// thread adds the 8 warps' column slots in warp order and writes the
// slice's row and column partials with coalesced stores.
//  * The swapped-patch body (TM = 64: every B3 launch, and B6 wherever 64
//    divides the strip): a thread's pairs are rows 4 ty + a, columns 4 tx + k,
//    and two of the fold stages need no selects (`swap_body`).
//  * The patch body (TM = 32, 16, 8: B6 strips whose height 64 does not
//    divide): kPer = TM / 16 (1 below 16), columns tx + 16 k. TM = 8 leaves
//    all but an 8 x 8 corner of the threads idle.
// Partials go to a (B, 2S, 3, W) buffer: row partials of shell s at slot s,
// position of the row in the strip; column partials at slot S + s, at the
// column tile's position (B3, W = Tg TM) or at the row tile's own position
// (B6, the compact layout of the Pallas strip kernel, W = Lb). Energies go
// to e_part[b, s Tl + i]. No float atomics: the same inputs give the same
// bits.
// B3 and B6 take a chromosome axis (grid row y): chromosome c's blocks read
// its B structures, its (rows, L) strip and its mask and write its
// partials, all at c's offsets, so its bits are those of a launch of its
// own. t and w are float32 or bfloat16 (AnnealConfig.pair_bf16; the
// Pallas bodies convert on read, pallas_energy.py:972-975, 1510-1513): the
// kernel is a template on their type and widens each element as it fills
// the register patch (tile_load.cuh), once a launch, so the loop over
// structures is the same code for both and a bf16 launch gives the float32
// launch's bits on the widened tiles.

#pragma once

#include <cuda_runtime.h>

#include "tile_load.cuh"
#include "warp_fold.cuh"

namespace c3d_tri {

using c3d::kThreads;
using c3d::kWarps;
constexpr float kEps = 1e-12f;

struct TriParams {
  int B, L;         // structures a chromosome, global (padded) length
  int Tl, Tg, S;    // the strip's row tiles, global tiles, shells Tg / 2 + 1
  int row0t;        // the strip's first global row tile (0 for B3)
  int W;            // width of one partial slot
  int compact;      // column partials at the row tile's position (B6)
  int BS;           // structures a slice
  float noe, vdw, r0;
  int C;            // chromosomes: grid row y, B structures each
  int rows;         // rows of t and w a chromosome (L for B3, the strip's Lb for B6)
};

// floats of shared memory a block needs for slices of BS structures (both
// bodies): two buffers of row and column coordinates, the warps' column
// slots, and the row sums followed by the half-warps' energies
__host__ __device__ constexpr int smem_floats(int TM, int BS) {
  return BS * (2 * 2 * 3 * TM + kWarps * 3 * (TM >= 16 ? TM : 16) + 3 * TM + 2 * kWarps);
}

// One pair: every product and sum spelled out (fmaf or a never-fused
// intrinsic), so the compiler fuses the same way in every pair. ww and nn
// carry 2 noe w pv and 2 vdw nb; e gathers s (ww u^2 + nn v^2).
__device__ __forceinline__ void pair_step(float ax, float ay, float az, float bx, float by,
                                          float bz, float tt, float ww, float nn,
                                          float r0, float& grx, float& gry, float& grz,
                                          float& gcx, float& gcy, float& gcz, float& e) {
  const float dx = ax - bx;
  const float dy = ay - by;
  const float dz = az - bz;
  const float s = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, kEps)));
  const float rinv = c3d::rsqrt_fast(s);
  const float u = fmaf(-tt, rinv, 1.0f);
  const float wu = __fmul_rn(ww, u);
  const float v = fmaxf(fmaf(r0, rinv, -1.0f), 0.f);
  const float nv = __fmul_rn(nn, v);
  e = fmaf(s, fmaf(nv, v, __fmul_rn(wu, u)), e);
  const float cf = __fsub_rn(wu, nv);
  grx = fmaf(cf, dx, grx);
  gry = fmaf(cf, dy, gry);
  grz = fmaf(cf, dz, grz);
  gcx = fmaf(-cf, dx, gcx);
  gcy = fmaf(-cf, dy, gcy);
  gcz = fmaf(-cf, dz, gcz);
}

// internal linkage: each source that includes this header gets its own
// kernel instantiations, so two objects in one library never register the
// same kernel twice
namespace {

// which tile pair a block computes: row tile ti of the strip (global ig),
// shell sh, column tile tj; not live: the even-Tg last shell's twin
struct BlockPlace {
  int ti, sh, ig, tj;
  bool live;
};

__device__ __forceinline__ BlockPlace place_block(const TriParams& q) {
  BlockPlace p;
  p.ti = blockIdx.x % q.Tl;
  p.sh = blockIdx.x / q.Tl;
  p.ig = q.row0t + p.ti;
  p.tj = (p.ig + p.sh) % q.Tg;
  p.live = !((q.Tg % 2 == 0) && p.sh == q.S - 1 && p.ig >= q.Tg / 2);
  return p;
}

// slice sl's coordinates into buffer sl & 1 of s_x ([2][BS][2][3][TM]): rows
// of the row tile, then of the column tile; beads past L are zero. Thread
// tid takes bead tid % TM of the structures tid / TM, + 256 / TM, ...
template <int TM>
__device__ __forceinline__ void stage_slice(float* s_x, const float* __restrict__ xT, int sl,
                                            int BS, int B, int L, int row0, int col0) {
  constexpr int kGroups = kThreads / TM;
  const int tp = threadIdx.x % TM, grp = threadIdx.x / TM;
  float* dst = s_x + (sl & 1) * BS * 6 * TM;
  const int nb = min(BS, B - sl * BS);
  for (int bl = grp; bl < nb; bl += kGroups) {
#pragma unroll
    for (int sc = 0; sc < 6; ++sc) {            // side * 3 + component
      const int bead = (sc >= 3 ? col0 : row0) + tp;
      const bool in = bead < L;
      c3d::copy_async(dst + (bl * 6 + sc) * TM + tp,
                      xT + ((size_t)(sl * BS + bl) * 3 + sc % 3) * L + (in ? bead : 0), in);
    }
  }
  c3d::copy_async_commit();
}

// the slice's energies: each structure's 2 kWarps half-warp sums in order,
// times the shell's scale (the tile carries 2 noe and 2 vdw: e = 1/4 s
// (ww u^2 + nn v^2) on the diagonal shell, 1/2 elsewhere); a dead twin 0
__device__ __forceinline__ void store_energies(const float* s_e, int stride,
                                               float* __restrict__ e_part, int sl, int BS,
                                               int nb, const TriParams& q,
                                               const BlockPlace& pl) {
  const float e_scale = pl.live ? (pl.sh == 0 ? 0.25f : 0.5f) : 0.0f;
  for (int bl = threadIdx.x; bl < nb; bl += kThreads) {
    float et = 0.f;
    if (pl.live)
      for (int h = 0; h < 2 * kWarps; ++h) et += s_e[bl * stride + h];
    e_part[((size_t)sl * BS + bl) * q.Tl * q.S + blockIdx.x] = e_scale * et;
  }
}

template <int TM, typename TT>
__device__ __forceinline__ void patch_body(const float* __restrict__ xT,
                                           const TT* __restrict__ t,
                                           const TT* __restrict__ w,
                                           const float* __restrict__ bm,
                                           float* __restrict__ part,
                                           float* __restrict__ e_part, const TriParams& q,
                                           float* smem) {
  constexpr int kPer = TM >= 16 ? TM / 16 : 1;
  constexpr int NC = 3 * kPer;        // a thread's column sums per structure
  constexpr int NR = 3 * kPer + 1;    // its row sums and its energy
  constexpr int HC = NC / 2;
  constexpr int kColSlot = NC * 16;   // one warp's column sums of one structure
  constexpr int kRowSlot = 3 * TM + 2 * kWarps;   // row sums, then energies
  const int BS = q.BS;
  float* s_x = smem;                            // [2][BS][2][3][TM] rows, columns
  float* s_col = s_x + 2 * BS * 6 * TM;         // [BS][kWarps][NC][16]
  float* s_row = s_col + BS * kWarps * kColSlot;   // [BS][3 TM rows + 2 kWarps energies]

  const BlockPlace pl = place_block(q);
  const int S = q.S, L = q.L, W = q.W, B = q.B, sh = pl.sh;
  const bool live = pl.live;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int lrow0 = pl.ti * TM;                    // the tile's rows in the strip
  const int row0 = pl.ig * TM, col0 = pl.tj * TM;  // global
  const bool active = TM >= 16 || (tx < TM && ty < TM);
  // for the epilogue's passes over a tile's TM beads: this thread's bead,
  // and which of the 256 / TM structures in flight it takes
  constexpr int kGroups = kThreads / TM;
  const int tp = tid % TM, grp = tid / TM;

  stage_slice<TM>(s_x, xT, 0, BS, B, L, row0, col0);

  // this thread's pairs: rows row0 + kPer ty + a, columns col0 + tx + 16 k;
  // beads past L are zero (no restraint, no vdw)
  float tt[kPer][kPer], ww[kPer][kPer], nn[kPer][kPer];
  const float two_noe = 2.0f * q.noe, two_vdw = 2.0f * q.vdw, r0 = q.r0;
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int r = row0 + kPer * ty + a;
    const int rl = lrow0 + kPer * ty + a;
    const float bmr = active && r < L ? bm[r] : 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = col0 + tx + 16 * k;
      const bool in = active && r < L && c < L;
      const float pv = in ? bmr * bm[c] : 0.f;
      const size_t idx = (size_t)rl * L + c;
      tt[a][k] = in ? c3d::tile_f32(t[idx]) : 0.f;
      ww[a][k] = in ? two_noe * (c3d::tile_f32(w[idx]) * pv) : 0.f;
      nn[a][k] = (abs(r - c) >= 2) ? two_vdw * pv : 0.f;
    }
  }
  // where this lane's one value of the row fold goes: value a * 3 + c is a
  // row sum, value NR - 1 the half-warp's energy
  int which;
  bool owner;
  c3d::fold_all_id<8, NR>(lane, which, owner);
  const bool is_e = which == NR - 1;
  const int row_p = kPer * ty + which / 3;
  owner = owner && (is_e || row_p < TM);
  float* row_dst = s_row + (is_e ? 3 * TM + warp * 2 + (lane >> 4)
                                 : (which % 3) * TM + (row_p < TM ? row_p : 0));
  // the column fold keeps values up HC + i of columns tx (up = lane >= 16)
  const bool up = lane & 16;
  float* col_dst = s_col + warp * kColSlot + (up ? HC : 0) * 16 + tx;

  const int nsl = (B + BS - 1) / BS;
  for (int sl = 0; sl < nsl; ++sl) {
    const int nb = min(BS, B - sl * BS);
    // this slice's coordinates have landed; every thread is done with the
    // other buffer and with the last slice's sums
    c3d::copy_async_wait<0>();
    __syncthreads();
    if (sl + 1 < nsl) stage_slice<TM>(s_x, xT, sl + 1, BS, B, L, row0, col0);
    const float* xs = s_x + (sl & 1) * BS * 6 * TM;

    if (live) {
      for (int bl = 0; bl < nb; ++bl) {
        const float* xr = xs + bl * 6 * TM + kPer * ty;
        const float* xk = xs + bl * 6 * TM + 3 * TM + tx;
        float ar[kPer][3], xc[kPer][3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int a = 0; a < kPer; ++a)
            ar[a][c] = (TM >= 16 || ty < TM) ? xr[c * TM + a] : 0.f;
#pragma unroll
          for (int k = 0; k < kPer; ++k)
            xc[k][c] = (TM >= 16 || tx < TM) ? xk[c * TM + 16 * k] : 0.f;
        }
        float gr[NR], gc[NC];
#pragma unroll
        for (int n = 0; n < NR; ++n) gr[n] = 0.f;
#pragma unroll
        for (int n = 0; n < NC; ++n) gc[n] = 0.f;
#pragma unroll
        for (int a = 0; a < kPer; ++a) {
#pragma unroll
          for (int k = 0; k < kPer; ++k)
            pair_step(ar[a][0], ar[a][1], ar[a][2], xc[k][0], xc[k][1], xc[k][2], tt[a][k],
                      ww[a][k], nn[a][k], r0, gr[3 * a], gr[3 * a + 1], gr[3 * a + 2],
                      gc[3 * k], gc[3 * k + 1], gc[3 * k + 2], gr[NR - 1]);
        }
        // rows and energy: over the 16 threads of a half-warp
        c3d::fold_all<8>(gr, lane);
        if (owner) row_dst[bl * kRowSlot] = gr[0];
        // columns: over the two half-warps; the warps meet after the loop
        c3d::fold<NC, 16>(gc, up);
        float* cd = col_dst + bl * kWarps * kColSlot;
#pragma unroll
        for (int i = 0; i < HC; ++i) cd[i * 16] = gc[i];
        if ((NC & 1) && !up) s_col[(bl * kWarps + warp) * kColSlot + (NC - 1) * 16 + tx] = gc[HC];
      }
    }
    __syncthreads();

    // the slice's partials: rows as they are, columns summed over the warps
    // in order (value k * 3 + c of column tx + 16 k); a dead twin writes 0
    const size_t slot = (size_t)3 * W;
    const int col_out0 = q.compact ? lrow0 : col0;
    for (int bl = grp; bl < nb; bl += kGroups) {
      const size_t b = (size_t)sl * BS + bl;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float gcol = 0.f, grow = 0.f;
        if (live) {
          grow = s_row[bl * kRowSlot + c * TM + tp];
          const float* cs =
              s_col + bl * kWarps * kColSlot + ((tp / 16) * 3 + c) * 16 + (tp % 16);
#pragma unroll
          for (int wi = 0; wi < kWarps; ++wi) gcol += cs[wi * kColSlot];
        }
        part[(b * 2 * S + sh) * slot + (size_t)c * W + lrow0 + tp] = grow;
        // the diagonal shell's rows already hold both ends of its pairs
        part[(b * 2 * S + S + sh) * slot + (size_t)c * W + col_out0 + tp] =
            sh == 0 ? 0.f : gcol;
      }
    }
    store_energies(s_row + 3 * TM, kRowSlot, e_part, sl, BS, nb, q, pl);
  }
}

// With -DC3D_TRI_TIMING (scripts/variant_probe_torch.py builds its library
// of variants so) thread 0 of the first kTriTimingBlocks blocks of
// chromosome 0 records the SM cycles of its prologue (to the first slice's
// barrier), its loops over structures, its epilogues (the slices' partials,
// from the barrier after the loops) and its whole run; the production build
// has none of this.
#ifdef C3D_TRI_TIMING
constexpr int kTriTimingBlocks = 4096, kTriTimingParts = 4;
__device__ long long c3d_tri_timing[kTriTimingBlocks * kTriTimingParts];
#endif

// The swapped-patch body (TM = 64): the patch body's 4 x 4 register tile,
// with a thread's columns 4 tx + k (k < 4) and two of its folds' selects
// traded for a layout. A lane with tx bit 3 set (the upper one of the pair
// that meets in the first row-fold stage) holds its rows 2, 3 in slots 0, 1
// and rows 0, 1 in slots 2, 3; a lane in the upper half-warp holds its
// columns 2, 3 in slots 0, 1 likewise; so the first stage of each fold keeps
// slots 0, 1 on every lane (warp_fold.cuh `fold_swapped`): 24 selects fewer
// a structure, 28.0 SASS a pair in the loop against the patch body's 29.6.
// The slots are fixed when the tile is loaded; the coordinates come in as
// float2 pairs from the swapped offsets. The warps' column slots hold whole
// columns, so the epilogue adds and stores four beads a thread as float4.
template <typename TT>
__device__ __forceinline__ void swap_body(const float* __restrict__ xT,
                                          const TT* __restrict__ t,
                                          const TT* __restrict__ w,
                                          const float* __restrict__ bm,
                                          float* __restrict__ part,
                                          float* __restrict__ e_part, const TriParams& q,
                                          float* smem) {
  constexpr int TM = 64, kPer = 4, NC = 12, NR = 13;
  constexpr int kColSlot = 3 * TM;    // one warp's column sums of one structure
  constexpr int kRowSlot = 3 * TM + 2 * kWarps;   // row sums, then energies
  const int BS = q.BS;
  float* s_x = smem;                            // [2][BS][2][3][TM] rows, columns
  float* s_col = s_x + 2 * BS * 6 * TM;         // [BS][kWarps][3][TM]
  float* s_row = s_col + BS * kWarps * kColSlot;   // [BS][3 TM rows + 2 kWarps energies]

#ifdef C3D_TRI_TIMING
  const long long t_start = clock64();
  long long t_part[kTriTimingParts] = {0, 0, 0, 0}, t_mark = t_start;
#endif
  const BlockPlace pl = place_block(q);
  const int S = q.S, L = q.L, W = q.W, B = q.B, sh = pl.sh;
  const bool live = pl.live;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int lrow0 = pl.ti * TM;                    // the tile's rows in the strip
  const int row0 = pl.ig * TM, col0 = pl.tj * TM;  // global
  // slot a holds row a ^ rs, slot k column k ^ cs
  const int rs = lane & 8 ? 2 : 0, cs = lane & 16 ? 2 : 0;

  stage_slice<TM>(s_x, xT, 0, BS, B, L, row0, col0);

  // this thread's pairs: rows row0 + 4 ty + (a ^ rs), columns col0 + 4 tx +
  // (k ^ cs); beads past L are zero (no restraint, no vdw)
  float tt[kPer][kPer], ww[kPer][kPer], nn[kPer][kPer];
  const float two_noe = 2.0f * q.noe, two_vdw = 2.0f * q.vdw, r0 = q.r0;
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int r = row0 + kPer * ty + (a ^ rs);
    const int rl = lrow0 + kPer * ty + (a ^ rs);
    const float bmr = r < L ? bm[r] : 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = col0 + kPer * tx + (k ^ cs);
      const bool in = r < L && c < L;
      const float pv = in ? bmr * bm[c] : 0.f;
      const size_t idx = (size_t)rl * L + c;
      tt[a][k] = in ? c3d::tile_f32(t[idx]) : 0.f;
      ww[a][k] = in ? two_noe * (c3d::tile_f32(w[idx]) * pv) : 0.f;
      nn[a][k] = (abs(r - c) >= 2) ? two_vdw * pv : 0.f;
    }
  }
  // where this lane's one value of the row fold goes: after the swapped
  // stage a lane holds values 0-5 (slot rows 0, 1: rows rs, rs + 1) and the
  // energy (value 12) in slot 6; then the plain stages over bits 2, 1, 0
  int id[NR];
  bool own[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    id[i] = i < 6 ? i : NR - 1;
    own[i] = i < 6 || !(lane & 8);
  }
  c3d::fold_id<7, 4>(id, own, lane & 4);
  c3d::fold_id<4, 2>(id, own, lane & 2);
  c3d::fold_id<2, 1>(id, own, lane & 1);
  const int which = id[0];
  const bool owner = own[0];
  const bool is_e = which == NR - 1;
  float* row_dst = s_row + (is_e ? 3 * TM + warp * 2 + (lane >> 4)
                                 : (which % 3) * TM + kPer * ty + which / 3 + rs);
  // the column fold leaves slots 0-5: columns 4 tx + cs + j, component c in
  // slot 3 j + c; a float2 a component
  float* col_dst = s_col + warp * kColSlot + kPer * tx + cs;

  const int nsl = (B + BS - 1) / BS;
  for (int sl = 0; sl < nsl; ++sl) {
    const int nb = min(BS, B - sl * BS);
    c3d::copy_async_wait<0>();
    __syncthreads();
#ifdef C3D_TRI_TIMING
    if (sl == 0) {
      t_mark = clock64();
      t_part[0] = t_mark - t_start;
    }
#endif
    if (sl + 1 < nsl) stage_slice<TM>(s_x, xT, sl + 1, BS, B, L, row0, col0);
    const float* xs = s_x + (sl & 1) * BS * 6 * TM;

    if (live) {
      for (int bl = 0; bl < nb; ++bl) {
        const float* xr = xs + bl * 6 * TM + kPer * ty;
        const float* xk = xs + bl * 6 * TM + 3 * TM + kPer * tx;
        float ar[kPer][3], xc[kPer][3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float2 r01 = *reinterpret_cast<const float2*>(xr + c * TM + rs);
          const float2 r23 = *reinterpret_cast<const float2*>(xr + c * TM + (rs ^ 2));
          const float2 c01 = *reinterpret_cast<const float2*>(xk + c * TM + cs);
          const float2 c23 = *reinterpret_cast<const float2*>(xk + c * TM + (cs ^ 2));
          ar[0][c] = r01.x;
          ar[1][c] = r01.y;
          ar[2][c] = r23.x;
          ar[3][c] = r23.y;
          xc[0][c] = c01.x;
          xc[1][c] = c01.y;
          xc[2][c] = c23.x;
          xc[3][c] = c23.y;
        }
        float gr[NR], gc[NC];
#pragma unroll
        for (int n = 0; n < NR; ++n) gr[n] = 0.f;
#pragma unroll
        for (int n = 0; n < NC; ++n) gc[n] = 0.f;
#pragma unroll
        for (int a = 0; a < kPer; ++a) {
#pragma unroll
          for (int k = 0; k < kPer; ++k)
            pair_step(ar[a][0], ar[a][1], ar[a][2], xc[k][0], xc[k][1], xc[k][2], tt[a][k],
                      ww[a][k], nn[a][k], r0, gr[3 * a], gr[3 * a + 1], gr[3 * a + 2],
                      gc[3 * k], gc[3 * k + 1], gc[3 * k + 2], gr[NR - 1]);
        }
        // rows and energy: over the 16 threads of a half-warp
        c3d::fold_swapped<NR, 8>(gr);
        c3d::fold<7, 4>(gr, lane & 4);
        c3d::fold<4, 2>(gr, lane & 2);
        c3d::fold<2, 1>(gr, lane & 1);
        if (owner) row_dst[bl * kRowSlot] = gr[0];
        // columns: over the two half-warps; the warps meet after the loop
        c3d::fold_swapped<NC, 16>(gc);
        float* cd = col_dst + bl * kWarps * kColSlot;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          *reinterpret_cast<float2*>(cd + c * TM) = make_float2(gc[c], gc[3 + c]);
      }
    }
#ifdef C3D_TRI_TIMING
    t_part[1] += clock64() - t_mark;
    t_mark = clock64();
#endif
    __syncthreads();

    // the slice's partials, four beads a thread: rows as they are, columns
    // summed over the warps in order; a dead twin writes 0. W, the tiles'
    // offsets and the slots are multiples of 4, so every float4 is aligned.
    const size_t slot = (size_t)3 * W;
    const int col_out0 = q.compact ? lrow0 : col0;
    for (int i = tid; i < nb * 3 * (TM / 4); i += kThreads) {
      const int bl = i / (3 * (TM / 4)), c = (i / (TM / 4)) % 3, p4 = 4 * (i % (TM / 4));
      const size_t b = (size_t)sl * BS + bl;
      float4 grow = make_float4(0.f, 0.f, 0.f, 0.f), gcol = grow;
      if (live) {
        grow = *reinterpret_cast<const float4*>(s_row + bl * kRowSlot + c * TM + p4);
        const float* cs_ = s_col + (bl * kWarps * 3 + c) * TM + p4;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) {
          const float4 v = *reinterpret_cast<const float4*>(cs_ + wi * kColSlot);
          gcol.x += v.x;
          gcol.y += v.y;
          gcol.z += v.z;
          gcol.w += v.w;
        }
      }
      *reinterpret_cast<float4*>(part + (b * 2 * S + sh) * slot + (size_t)c * W + lrow0 + p4) =
          grow;
      // the diagonal shell's rows already hold both ends of its pairs
      *reinterpret_cast<float4*>(part + (b * 2 * S + S + sh) * slot + (size_t)c * W + col_out0 +
                                 p4) = sh == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : gcol;
    }
    store_energies(s_row + 3 * TM, kRowSlot, e_part, sl, BS, nb, q, pl);
#ifdef C3D_TRI_TIMING
    {
      const long long now = clock64();
      t_part[2] += now - t_mark;
      t_mark = now;
    }
#endif
  }
#ifdef C3D_TRI_TIMING
  t_part[3] = clock64() - t_start;
  if (tid == 0 && blockIdx.y == 0 && blockIdx.x < kTriTimingBlocks)
    for (int i = 0; i < kTriTimingParts; ++i)
      c3d_tri_timing[blockIdx.x * kTriTimingParts + i] = t_part[i];
#endif
}

template <int TM, typename TT>
__global__ void __launch_bounds__(kThreads, 2)
tri_pair_kernel(const float* __restrict__ xT,   // (C B, 3, L)
                const TT* __restrict__ t,       // (C, rows, L) target rows of the strip
                const TT* __restrict__ w,       // (C, rows, L) folded weights
                const float* __restrict__ bm,   // (C, L) bead masks
                float* __restrict__ part,       // (C B, 2S, 3, W) out
                float* __restrict__ e_part,     // (C B, Tl S) out
                TriParams q) {
  extern __shared__ __align__(16) float smem[];
  // chromosome blockIdx.y: its B structures, tiles, mask and partials, so
  // its blocks compute what a launch of its own computes
  const size_t chrom = blockIdx.y;
  xT += chrom * q.B * 3 * q.L;
  t += chrom * q.rows * q.L;
  w += chrom * q.rows * q.L;
  bm += chrom * q.L;
  part += chrom * q.B * 2 * q.S * 3 * q.W;
  e_part += chrom * q.B * q.Tl * q.S;
  if constexpr (TM == 64)
    swap_body<TT>(xT, t, w, bm, part, e_part, q, smem);
  else
    patch_body<TM, TT>(xT, t, w, bm, part, e_part, q, smem);
}

// the pair kernel for one tile edge and tile type, with the shared memory
// it asks for (the same for both tile types)
template <int TM, typename TT>
cudaError_t launch_pairs(const float* xT, const TT* t, const TT* w,
                         const float* bm, float* part, float* e_part,
                         const TriParams& q, cudaStream_t st) {
  const int smem = smem_floats(TM, q.BS) * (int)sizeof(float);
  // past the 227 KB a block can opt into, the attribute call fails
  cudaError_t err = cudaFuncSetAttribute(
      tri_pair_kernel<TM, TT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(q.Tl * q.S, q.C);
  tri_pair_kernel<TM, TT><<<grid, kThreads, smem, st>>>(xT, t, w, bm, part, e_part, q);
  return cudaGetLastError();
}

}  // namespace
}  // namespace c3d_tri
