// The staged tile-pair body: the design that scripts/variant_probe_torch.py
// times against the shipped bodies of tri_pair.cuh (tri_pair_variants.cu,
// variants 2-5). The block stages its 64 x 64 restraint tile in shared
// memory once (t, 2 noe w pv and 2 vdw nb, each lane's pairs in float4
// groups of its own, widened from bfloat16 on the way in), which frees the
// 48 registers of the register tile for a lane patch of 8 x PC pairs a
// structure: a structure is 128 / PC units of 32 rows x 8 PC columns, and
// the 8 warps take a slice's units in turn (up to 20 structures a slice at
// PC = 8, so B = 20 and 10 are one slice each). Per column quad the 12
// column sums fold over the 4 lanes that share the columns; after the
// quads the 24 row sums fold over the 8 lanes that share the rows, and a
// unit that spans the tile's columns stores its row partials directly;
// after a slice's units one barrier, then the units' column (and row) sums
// and energies are added in unit order. Every pair's math is tri_pair.cuh's
// `pair_step`, so a structure's bits depend on neither the warp nor the
// slice that computed it. kUniformVdw: blocks whose 128 beads are all real
// (mask 1) and whose tiles lie two or more apart stage t and 2 noe w pv only
// and take 2 vdw nb = 2 vdw (its exact value there) as a constant.
//
// Measured on an H100 (PERF.md §6): slower than the register-tile
// bodies at every probed shape; the smem tile costs shared-memory reads a
// pair, and at B = 10 the 20 units leave half the warps idle for a third
// of a block.

#pragma once

#include "tri_pair.cuh"

namespace c3d_tri {

// The staged body's geometry at TM = 64 for a lane patch of 8 rows x PC
// columns: lanes 4 (rg) x 8 (cg), so a unit is 32 rows x 8 PC columns.
template <int PC>
struct Staged {
  static constexpr int TM = 64, PR = 8, LC = 8, LR = 4;
  static constexpr int RU = LR * PR, CU = LC * PC;      // a unit's rows, columns
  static constexpr int NRU = TM / RU, NCU = TM / CU;
  static constexpr int U = NRU * NCU;                   // units a structure
  static constexpr int P = PR * PC;                     // pairs a lane a unit
  static constexpr bool kRowDirect = NCU == 1;          // a unit's rows are whole
  static constexpr int kTile = 3 * TM * TM;             // t, 2 noe w pv, 2 vdw nb
  static constexpr int kCoords = 6 * TM;                // rows, then columns; x, y, z
  static constexpr int kRows = kRowDirect ? 0 : NCU * 3 * TM;
  static constexpr int kCols = NRU * 3 * TM;
  static constexpr int kE = U * LR;
  static constexpr int kPer = kCoords + kRows + kCols + kE;   // a structure of a slice
  // floats of shared memory for slices of BS structures
  __host__ __device__ static constexpr int floats(int BS) { return kTile + BS * kPer; }
  static_assert(PC % 4 == 0 && TM % CU == 0, "column quads that tile the unit");
};


namespace {

// One unit of one structure, on one warp: the lane's 8 x PC pairs in column
// quads, each quad's column sums folded over the 4 lanes that share them
// (lane bits 4, 3: lane rg keeps column i = rg) and stored at cd + 32 j
// (component stride 64); the 24 row sums and the energy are left unfolded
// in gr and e. xr: the lane's rows, xc: its first column quad (component
// stride 64, quad j at + 32 j); tq: its first float4 group of the staged
// tile, NV values a group (kClean: t and 2 noe w pv, and every pair's
// 2 vdw nb is two_vdw).
template <int PC, bool kClean, int kUnrollJ>
__device__ __forceinline__ void staged_unit(const float* __restrict__ xr,
                                            const float* __restrict__ xc,
                                            const float4* __restrict__ tq, float two_vdw,
                                            float r0, int lane, float* __restrict__ cd,
                                            float (&gr)[24], float& e) {
  constexpr int TM = 64, PR = 8, NV = kClean ? 2 : 3;
  float ar[PR][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int a4 = 0; a4 < PR / 4; ++a4) {
      const float4 v = *reinterpret_cast<const float4*>(xr + c * TM + 4 * a4);
      ar[4 * a4][c] = v.x;
      ar[4 * a4 + 1][c] = v.y;
      ar[4 * a4 + 2][c] = v.z;
      ar[4 * a4 + 3][c] = v.w;
    }
  }
#pragma unroll kUnrollJ
  for (int j = 0; j < PC / 4; ++j) {
    float xq[4][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(xc + c * TM + 32 * j);
      xq[0][c] = v.x;
      xq[1][c] = v.y;
      xq[2][c] = v.z;
      xq[3][c] = v.w;
    }
    float gc[12];
#pragma unroll
    for (int n = 0; n < 12; ++n) gc[n] = 0.f;
    const float4* tj = tq + j * PR * NV * 32;     // 4 columns x PR / 4 groups
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int a4 = 0; a4 < PR / 4; ++a4) {
        const int g = i * (PR / 4) + a4;
        const float4 T = tj[(g * NV) * 32];
        const float4 Wv = tj[(g * NV + 1) * 32];
        const float4 N = kClean ? make_float4(two_vdw, two_vdw, two_vdw, two_vdw)
                                : tj[(g * NV + NV - 1) * 32];
        const float tt[4] = {T.x, T.y, T.z, T.w};
        const float ww[4] = {Wv.x, Wv.y, Wv.z, Wv.w};
        const float nn[4] = {N.x, N.y, N.z, N.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int a = 4 * a4 + h;
          pair_step(ar[a][0], ar[a][1], ar[a][2], xq[i][0], xq[i][1], xq[i][2], tt[h], ww[h],
                    nn[h], r0, gr[3 * a], gr[3 * a + 1], gr[3 * a + 2], gc[3 * i],
                    gc[3 * i + 1], gc[3 * i + 2], e);
        }
      }
    }
    c3d::fold<12, 16>(gc, lane & 16);
    c3d::fold<6, 8>(gc, lane & 8);
    cd[32 * j] = gc[0];
    cd[TM + 32 * j] = gc[1];
    cd[2 * TM + 32 * j] = gc[2];
  }
}

// kUniformVdw: blocks whose 128 beads are all real (mask 1) and whose tiles
// lie two or more apart stage t and 2 noe w pv only and take 2 vdw nb =
// 2 vdw (its exact value there: pv = 1, |i - j| >= 2) as a constant, a third
// less shared memory read a pair; scripts/probe_variants/ times the body
// without it
template <typename TT, int PC, bool kUniformVdw = false, int kUnrollJ = 1>
__device__ __forceinline__ void staged_body(const float* __restrict__ xT,
                                            const TT* __restrict__ t,
                                            const TT* __restrict__ w,
                                            const float* __restrict__ bm,
                                            float* __restrict__ part,
                                            float* __restrict__ e_part, const TriParams& q,
                                            float* smem) {
  using G = Staged<PC>;
  constexpr int TM = G::TM, PR = G::PR, LC = G::LC, RU = G::RU, CU = G::CU;
  constexpr int NRU = G::NRU, NCU = G::NCU, U = G::U, P = G::P;
  const int BS = q.BS;
  float* s_tile = smem;                        // [U][P/4][NV][32 lanes][4]
  float* s_x = s_tile + G::kTile;              // [BS][2][3][TM] rows, columns
  float* s_row = s_x + BS * G::kCoords;        // [BS][NCU][3][TM] (a unit's rows not whole)
  float* s_col = s_row + BS * G::kRows;        // [BS][NRU][3][TM]
  float* s_e = s_col + BS * G::kCols;          // [BS][U][LR]

  const BlockPlace pl = place_block(q);
  const int S = q.S, L = q.L, W = q.W, B = q.B, sh = pl.sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lrow0 = pl.ti * TM;                    // the tile's rows in the strip
  const int row0 = pl.ig * TM, col0 = pl.tj * TM;  // global
  const float two_vdw = 2.0f * q.vdw, r0 = q.r0;

  // slice sl's coordinates: rows of the row tile, then of the column tile;
  // beads past L are zero
  auto stage = [&](int sl) {
    const int nb = min(BS, B - sl * BS);
    for (int i = tid; i < nb * G::kCoords; i += kThreads) {
      const int bl = i / G::kCoords, sc = (i / TM) % 6, tp = i % TM;   // sc: side * 3 + component
      const int bead = (sc >= 3 ? col0 : row0) + tp;
      const bool in = bead < L;
      c3d::copy_async(s_x + i, xT + ((size_t)(sl * BS + bl) * 3 + sc % 3) * L + (in ? bead : 0),
                      in);
    }
    c3d::copy_async_commit();
  };
  stage(0);

  // the tile: this thread's column c and rows r = tid / TM + 4 m, all
  // loads first; pair (r, c) goes to unit (r / RU, c / CU), lane (rg, cg)
  // and slot p = k PR + a of its patch, k = 4 j + i its column there; beads
  // past L are zero (no restraint, no vdw)
  bool clean = false;
  if (pl.live) {
    constexpr int kRowsA = TM * TM / kThreads;
    const int c = tid % TM, cc = c % CU, gc = col0 + c;
    const float bmc = gc < L ? bm[gc] : 0.f;
    float tv[kRowsA], wv[kRowsA], bmr[kRowsA];
    bool ones = gc < L && bmc == 1.0f;
#pragma unroll
    for (int m = 0; m < kRowsA; ++m) {
      const int gr = row0 + tid / TM + 4 * m;
      const bool in = gr < L && gc < L;
      const size_t idx = (size_t)(lrow0 + tid / TM + 4 * m) * L + gc;
      tv[m] = in ? c3d::tile_f32(t[idx]) : 0.f;
      wv[m] = in ? c3d::tile_f32(w[idx]) : 0.f;
      bmr[m] = gr < L ? bm[gr] : 0.f;
      ones = ones && gr < L && bmr[m] == 1.0f;
    }
    clean = kUniformVdw && __syncthreads_and(ones) && abs(pl.ig - pl.tj) >= 2;
    const int nv = clean ? 2 : 3;
    const float two_noe = 2.0f * q.noe;
#pragma unroll
    for (int m = 0; m < kRowsA; ++m) {
      const int r = tid / TM + 4 * m, gr = row0 + r;
      const bool in = gr < L && gc < L;
      const float pv = in ? bmr[m] * bmc : 0.f;
      const int unit = (r / RU) * NCU + c / CU;
      const int ln = ((r % RU) / PR) * LC + (cc / 4) % LC;
      const int p = ((cc / (4 * LC)) * 4 + cc % 4) * PR + r % PR;
      float* dst = s_tile + ((unit * (P / 4) + p / 4) * nv) * 128 + ln * 4 + (p & 3);
      dst[0] = tv[m];
      dst[128] = in ? two_noe * (wv[m] * pv) : 0.f;
      if (!clean) dst[256] = (abs(gr - gc) >= 2) ? two_vdw * pv : 0.f;
    }
  }

  const int rg = lane / LC, cg = lane % LC;
  const int nsl = (B + BS - 1) / BS;
  for (int sl = 0; sl < nsl; ++sl) {
    const int nb = min(BS, B - sl * BS);
    // this slice's coordinates (and, first, the tile) have landed; every
    // thread is done with the last slice's sums
    c3d::copy_async_wait<0>();
    __syncthreads();

    if (pl.live) {
      for (int u = warp; u < nb * U; u += kWarps) {
        const int bl = u / U, uu = u % U, ru = uu / NCU, cu = uu % NCU;
        const float* xs = s_x + bl * G::kCoords;
        const float* xr = xs + ru * RU + rg * PR;
        const float* xc = xs + 3 * TM + cu * CU + 4 * cg;
        float* cd = s_col + bl * G::kCols + ru * 3 * TM + cu * CU + 4 * cg + rg;
        const float4* tq = reinterpret_cast<const float4*>(s_tile) + lane;
        float gr[3 * PR], e = 0.f;
#pragma unroll
        for (int n = 0; n < 3 * PR; ++n) gr[n] = 0.f;
        if (kUniformVdw && clean)
          staged_unit<PC, true, kUnrollJ>(xr, xc, tq + uu * (P / 4) * 2 * 32, two_vdw, r0, lane,
                                          cd, gr, e);
        else
          staged_unit<PC, false, kUnrollJ>(xr, xc, tq + uu * (P / 4) * 3 * 32, two_vdw, r0, lane,
                                           cd, gr, e);
        // the rows over the 8 lanes that share them (lane bits 2, 1, 0):
        // lane cg keeps row a = cg; the energy over the same lanes
        c3d::fold<24, 4>(gr, lane & 4);
        c3d::fold<12, 2>(gr, lane & 2);
        c3d::fold<6, 1>(gr, lane & 1);
        e += __shfl_xor_sync(0xffffffffu, e, 4);
        e += __shfl_xor_sync(0xffffffffu, e, 2);
        e += __shfl_xor_sync(0xffffffffu, e, 1);
        const int rrow = ru * RU + rg * PR + cg;
        if constexpr (G::kRowDirect) {
          const size_t b = (size_t)sl * BS + bl;
          float* pr = part + (b * 2 * S + sh) * (size_t)3 * W + lrow0 + rrow;
          pr[0] = gr[0];
          pr[W] = gr[1];
          pr[2 * W] = gr[2];
        } else {
          float* rd = s_row + bl * G::kRows + cu * 3 * TM + rrow;
          rd[0] = gr[0];
          rd[TM] = gr[1];
          rd[2 * TM] = gr[2];
        }
        if (cg == 0) s_e[bl * G::kE + uu * G::LR + rg] = e;
      }
    }
    __syncthreads();
    if (sl + 1 < nsl) stage(sl + 1);

    // the slice's partials: columns (and rows, where a unit's rows are not
    // whole) summed over the units in order; a dead twin writes 0
    const size_t slot = (size_t)3 * W;
    const int col_out0 = q.compact ? lrow0 : col0;
    for (int i = tid; i < nb * 3 * TM; i += kThreads) {
      const int bl = i / (3 * TM), cp = i % (3 * TM), c = cp / TM, pos = cp % TM;
      const size_t b = (size_t)sl * BS + bl;
      float gcol = 0.f;
      if (pl.live) {
#pragma unroll
        for (int k = 0; k < NRU; ++k) gcol += s_col[bl * G::kCols + k * 3 * TM + cp];
      }
      // the diagonal shell's rows already hold both ends of its pairs
      part[(b * 2 * S + S + sh) * slot + (size_t)c * W + col_out0 + pos] = sh == 0 ? 0.f : gcol;
      if (!G::kRowDirect || !pl.live) {
        float grow = 0.f;
        if (pl.live) {
#pragma unroll
          for (int k = 0; k < NCU; ++k) grow += s_row[bl * G::kRows + k * 3 * TM + cp];
        }
        part[(b * 2 * S + sh) * slot + (size_t)c * W + lrow0 + pos] = grow;
      }
    }
    // the tile carries 2 noe and 2 vdw: e = 1/4 s (ww u^2 + nn v^2)
    const float e_scale = pl.live ? (sh == 0 ? 0.25f : 0.5f) : 0.0f;
    for (int bl = tid; bl < nb; bl += kThreads) {
      float et = 0.f;
      if (pl.live)
        for (int h = 0; h < G::kE; ++h) et += s_e[bl * G::kE + h];
      e_part[((size_t)sl * BS + bl) * q.Tl * S + blockIdx.x] = e_scale * et;
    }
  }
}

}  // namespace
}  // namespace c3d_tri
