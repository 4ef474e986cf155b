// Designs of the tile-pair body of kernels B3 and B6 (tri_pair.cuh), timed
// against each other and the shipped body by scripts/variant_probe_torch.py.
// One entry, c3d_tri_probe, runs a whole B3 call (pairs, then exact_tri.cu's
// reduce) or a whole B6 call (pairs, then exact_tri_strip.cu's assembly) at
// tile 64 with the pair kernel of one variant:
//   0  "regs 4x4": tri_pair.cuh's patch body at tile 64, which the swapped
//      body replaced there (4 x 4 pairs a thread a structure in registers,
//      columns tx + 16 k, 10 structures a slice);
//   1  "smem 4x4": the same patch with the tile read from shared memory
//      (t, 2 noe w pv, 2 vdw nb as three float4 a row of the patch), which
//      frees its 48 registers; 4 structures a slice fit beside the tile;
//   2  "staged 8x4": tri_pair_staged.cuh with a lane patch of 8 rows x 4
//      columns (units of 32 x 32, row sums added over two units after the
//      slice; 14 structures a slice);
//   3  "staged 8x8": the same at 8 x 8 (units of 32 x 64; 20 structures a
//      slice, so B = 20 and 10 are one slice);
//   4  "staged 8x8 uniform vdw": blocks of real beads two tiles apart
//      stage t and 2 noe w pv only, 2 vdw nb a constant;
//   5  "staged 8x8 j unrolled": both column quads of a unit in one
//      straight run;
//   6  "swapped 4x4": tri_pair.cuh's swapped-patch body, shipped at tile 64
//      (variant 0 with columns 4 tx + k, select-free first fold stages and
//      four beads a thread in the epilogue).
// Each variant writes the same (B, 2S, 3, W) partials, so the shipped
// reduce and assembly sum them. The library is built with -DC3D_TRI_TIMING,
// so the swapped body (variant 6) records its phases' SM cycles, which
// c3d_tri_timing_read returns. Build: nvcc with the package's flags and
// -I chromosome3d_tpu_torch/csrc.

#include "exact_tri.cu"
#include "exact_tri_strip.cu"
#include "tri_pair_staged.cuh"

namespace {

using c3d_tri::TriParams;

constexpr int kTMp = 64;

// variant 1: the patch body at tile 64 with the tile in shared memory
__device__ __forceinline__ void patch_smem_body(const float* __restrict__ xT,
                                                const float* __restrict__ t,
                                                const float* __restrict__ w,
                                                const float* __restrict__ bm,
                                                float* __restrict__ part,
                                                float* __restrict__ e_part,
                                                const TriParams& q, float* smem) {
  constexpr int TM = kTMp, kPer = 4, NC = 12, NR = 13, HC = 6;
  constexpr int kColSlot = NC * 16, kRowSlot = 3 * TM + 2 * c3d::kWarps;
  const int BS = q.BS;
  float4* s_tile = reinterpret_cast<float4*>(smem);   // [kPer rows][3][256 threads]
  float* s_x = smem + 3 * TM * TM;
  float* s_col = s_x + 2 * BS * 6 * TM;
  float* s_row = s_col + BS * c3d::kWarps * kColSlot;

  const c3d_tri::BlockPlace pl = c3d_tri::place_block(q);
  const int S = q.S, L = q.L, W = q.W, B = q.B, sh = pl.sh;
  const bool live = pl.live;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31, warp = tid >> 5;
  const int lrow0 = pl.ti * TM, row0 = pl.ig * TM, col0 = pl.tj * TM;
  constexpr int kGroups = kThreads / TM;
  const int tp = tid % TM, grp = tid / TM;

  c3d_tri::stage_slice<TM>(s_x, xT, 0, BS, B, L, row0, col0);

  const float two_noe = 2.0f * q.noe, two_vdw = 2.0f * q.vdw, r0 = q.r0;
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int r = row0 + kPer * ty + a, rl = lrow0 + kPer * ty + a;
    const float bmr = r < L ? bm[r] : 0.f;
    float v[3][4];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = col0 + tx + 16 * k;
      const bool in = r < L && c < L;
      const float pv = in ? bmr * bm[c] : 0.f;
      const size_t idx = (size_t)rl * L + c;
      v[0][k] = in ? t[idx] : 0.f;
      v[1][k] = in ? two_noe * (w[idx] * pv) : 0.f;
      v[2][k] = (abs(r - c) >= 2) ? two_vdw * pv : 0.f;
    }
#pragma unroll
    for (int m = 0; m < 3; ++m)
      s_tile[(a * 3 + m) * kThreads + tid] = make_float4(v[m][0], v[m][1], v[m][2], v[m][3]);
  }
  int which;
  bool owner;
  c3d::fold_all_id<8, NR>(lane, which, owner);
  const bool is_e = which == NR - 1;
  const int row_p = kPer * ty + which / 3;
  owner = owner && (is_e || row_p < TM);
  float* row_dst = s_row + (is_e ? 3 * TM + warp * 2 + (lane >> 4)
                                 : (which % 3) * TM + (row_p < TM ? row_p : 0));
  const bool up = lane & 16;
  float* col_dst = s_col + warp * kColSlot + (up ? HC : 0) * 16 + tx;

  const int nsl = (B + BS - 1) / BS;
  for (int sl = 0; sl < nsl; ++sl) {
    const int nb = min(BS, B - sl * BS);
    c3d::copy_async_wait<0>();
    __syncthreads();
    if (sl + 1 < nsl) c3d_tri::stage_slice<TM>(s_x, xT, sl + 1, BS, B, L, row0, col0);
    const float* xs = s_x + (sl & 1) * BS * 6 * TM;
    if (live) {
      for (int bl = 0; bl < nb; ++bl) {
        const float* xr = xs + bl * 6 * TM + kPer * ty;
        const float* xk = xs + bl * 6 * TM + 3 * TM + tx;
        float ar[kPer][3], xc[kPer][3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int a = 0; a < kPer; ++a) ar[a][c] = xr[c * TM + a];
#pragma unroll
          for (int k = 0; k < kPer; ++k) xc[k][c] = xk[c * TM + 16 * k];
        }
        float gr[NR], gc[NC];
#pragma unroll
        for (int n = 0; n < NR; ++n) gr[n] = 0.f;
#pragma unroll
        for (int n = 0; n < NC; ++n) gc[n] = 0.f;
#pragma unroll
        for (int a = 0; a < kPer; ++a) {
          const float4 T = s_tile[(a * 3) * kThreads + tid];
          const float4 Wv = s_tile[(a * 3 + 1) * kThreads + tid];
          const float4 N = s_tile[(a * 3 + 2) * kThreads + tid];
          const float tt[4] = {T.x, T.y, T.z, T.w}, ww[4] = {Wv.x, Wv.y, Wv.z, Wv.w},
                      nn[4] = {N.x, N.y, N.z, N.w};
#pragma unroll
          for (int k = 0; k < kPer; ++k)
            c3d_tri::pair_step(ar[a][0], ar[a][1], ar[a][2], xc[k][0], xc[k][1], xc[k][2],
                               tt[k], ww[k], nn[k], r0, gr[3 * a], gr[3 * a + 1],
                               gr[3 * a + 2], gc[3 * k], gc[3 * k + 1], gc[3 * k + 2],
                               gr[NR - 1]);
        }
        c3d::fold_all<8>(gr, lane);
        if (owner) row_dst[bl * kRowSlot] = gr[0];
        c3d::fold<NC, 16>(gc, up);
        float* cd = col_dst + bl * c3d::kWarps * kColSlot;
#pragma unroll
        for (int i = 0; i < HC; ++i) cd[i * 16] = gc[i];
      }
    }
    __syncthreads();
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
              s_col + bl * c3d::kWarps * kColSlot + ((tp / 16) * 3 + c) * 16 + (tp % 16);
#pragma unroll
          for (int wi = 0; wi < c3d::kWarps; ++wi) gcol += cs[wi * kColSlot];
        }
        part[(b * 2 * S + sh) * slot + (size_t)c * W + lrow0 + tp] = grow;
        part[(b * 2 * S + S + sh) * slot + (size_t)c * W + col_out0 + tp] =
            sh == 0 ? 0.f : gcol;
      }
    }
    c3d_tri::store_energies(s_row + 3 * TM, kRowSlot, e_part, sl, BS, nb, q, pl);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, 2)
probe_pairs(const float* __restrict__ xT, const float* __restrict__ t,
            const float* __restrict__ w, const float* __restrict__ bm,
            float* __restrict__ part, float* __restrict__ e_part, TriParams q) {
  extern __shared__ __align__(16) float smem[];
  const size_t chrom = blockIdx.y;
  xT += chrom * q.B * 3 * q.L;
  t += chrom * q.rows * q.L;
  w += chrom * q.rows * q.L;
  bm += chrom * q.L;
  part += chrom * q.B * 2 * q.S * 3 * q.W;
  e_part += chrom * q.B * q.Tl * q.S;
  if constexpr (V == 0)
    c3d_tri::patch_body<kTMp, float>(xT, t, w, bm, part, e_part, q, smem);
  else if constexpr (V == 1)
    patch_smem_body(xT, t, w, bm, part, e_part, q, smem);
  else if constexpr (V == 2)
    c3d_tri::staged_body<float, 4>(xT, t, w, bm, part, e_part, q, smem);
  else if constexpr (V == 3)
    c3d_tri::staged_body<float, 8>(xT, t, w, bm, part, e_part, q, smem);
  else if constexpr (V == 4)
    c3d_tri::staged_body<float, 8, true>(xT, t, w, bm, part, e_part, q, smem);
  else if constexpr (V == 5)
    c3d_tri::staged_body<float, 8, false, 2>(xT, t, w, bm, part, e_part, q, smem);
  else
    c3d_tri::swap_body<float>(xT, t, w, bm, part, e_part, q, smem);
}

// the largest slice each variant takes, and its shared memory for slices of BS
constexpr int kSliceMax[7] = {10, 4, 14, 20, 20, 20, 10};

int probe_smem_floats(int V, int BS) {
  switch (V) {
    case 0:
    case 6: return c3d_tri::smem_floats(kTMp, BS);
    case 1: return 3 * kTMp * kTMp + c3d_tri::smem_floats(kTMp, BS);
    case 2: return c3d_tri::Staged<4>::floats(BS);
    default: return c3d_tri::Staged<8>::floats(BS);
  }
}

template <int V>
cudaError_t probe_launch(const float* xT, const float* t, const float* w, const float* bm,
                         float* part, float* e_part, const TriParams& q, cudaStream_t st) {
  const int smem = probe_smem_floats(V, q.BS) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(probe_pairs<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(probe_pairs<V>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  probe_pairs<V><<<dim3(q.Tl * q.S, q.C), kThreads, smem, st>>>(xT, t, w, bm, part, e_part, q);
  return cudaGetLastError();
}

}  // namespace

// variant 0-6 (above); strip 0: B3 over all of (C, L, L) t and w; strip 1:
// B6 on the (C, Lb, L) strips of rows row0 .. row0 + Lb - 1 (64 divides Lb,
// row0 and L). part, e_part: the shipped wrappers' scratch shapes at tile
// 64 (tri_plan, strip_plan). Each variant takes its own slices of the n
// structures a chromosome.
extern "C" int c3d_tri_probe(int variant, int strip, const float* xT, const float* t,
                             const float* w, const float* bm, float* part, float* e_part,
                             float* gT, float* e, int C, int n, int L, int row0, int Lb,
                             float noe, float vdw, float vdw_radius, void* stream) {
  if (variant < 0 || variant > 6 || n <= 0 || C <= 0 ||
      (strip && (Lb % kTMp || L % kTMp || row0 % kTMp)))
    return (int)cudaErrorInvalidValue;
  const int nsl = (n + kSliceMax[variant] - 1) / kSliceMax[variant];
  const int bslice = (n + nsl - 1) / nsl;
  const int Tg = (L + kTMp - 1) / kTMp, S = Tg / 2 + 1;
  const int Tl = strip ? Lb / kTMp : Tg;
  const TriParams q{n, L, Tl, Tg, S, strip ? row0 / kTMp : 0, strip ? Lb : Tg * kTMp, strip,
                    bslice, noe, vdw, vdw_radius, C, strip ? Lb : L};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (variant) {
    case 0: err = probe_launch<0>(xT, t, w, bm, part, e_part, q, st); break;
    case 1: err = probe_launch<1>(xT, t, w, bm, part, e_part, q, st); break;
    case 2: err = probe_launch<2>(xT, t, w, bm, part, e_part, q, st); break;
    case 3: err = probe_launch<3>(xT, t, w, bm, part, e_part, q, st); break;
    case 4: err = probe_launch<4>(xT, t, w, bm, part, e_part, q, st); break;
    case 5: err = probe_launch<5>(xT, t, w, bm, part, e_part, q, st); break;
    default: err = probe_launch<6>(xT, t, w, bm, part, e_part, q, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((3 * L + kThreads - 1) / kThreads, C * n);
  if (strip)
    strip_assemble_kernel<<<grid, kThreads, 0, st>>>(part, e_part, gT, e, L, Lb, kTMp, Tl, Tg,
                                                     S, row0 / kTMp, Tl * S);
  else
    tri_reduce_kernel<<<grid, kThreads, 0, st>>>(part, e_part, gT, e, L, Tg * kTMp, 2 * S,
                                                 Tg * S);
  return (int)cudaGetLastError();
}

// the cycles tri_pair.cuh's C3D_TRI_TIMING build recorded in the last
// launch of the swapped body: (4096 blocks, 4 parts), into host_out
extern "C" int c3d_tri_timing_read(long long* host_out) {
  return (int)cudaMemcpyFromSymbol(host_out, c3d_tri::c3d_tri_timing,
                                   sizeof(c3d_tri::c3d_tri_timing));
}
