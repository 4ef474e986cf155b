// Kernel B1: a whole phase of the annealing schedule in one launch — for
// steps k0 <= k < k1, pair energy and gradient, chain bond, per-bead
// gradient clip, Adam with the bias corrections of the schedule table,
// CLT-4 Langevin noise and the coordinate update, for a batch of structures
// sharing one restraint set, or for the C chromosomes of a genome bucket
// (C x n_per structures, each chromosome with its own tiles, bead mask and
// noise seed), with every step's per-structure energy written out.
//
// Replaces: chromosome3d_tpu/ops/pallas_energy.py `_kernel_fused_step`
// (entry `pallas_fused_step_batched`, helpers `_t_layout_bond` and
// `_t_layout_noise`) as the JAX solver runs it: one step inside a compiled
// `lax.scan` whose rows are the schedule (solver/anneal.py, `srows`). Here
// the scan is the kernel's own loop: the step's scalars come from row k of a
// device table, the step index is the loop variable, and the history is an
// output. On the port's main path it runs twice a solve (the hot phase with
// B = 2 x models, then the rest with B = models; L = the length bucket). On
// the genome path it runs twice a bucket: the JAX runner's vmap of the solve
// over the bucket's chromosomes (pallas_energy.py:331-336: tiles and seed per
// lane) is the chromosome axis here, chromosome c's noise its own stream
// under seeds[c] with its structures numbered from 0, so its bits are a
// launch of its own in the same plan mode.
//
// Pair terms use the exact-restraint algebra in rsqrt space:
//   s = |x_i - x_j|^2 + eps, rinv = rsqrt(s)
//   u = 1 - t_ij rinv, v = max(r0 rinv - 1, 0)
//   c_ij = w_ij u - 2 vdw nb_ij v              (the force coefficient)
//   e_i  = sum_j s (w_ij u^2 / 4 + vdw nb_ij v^2 / 2)
//   g_i  = sum_j c_ij (x_i - x_j)
// (the Pallas kernel's x_i sum_j c_ij - (c @ X)_i, summed over the
// differences already in registers: no float32 cancellation between two
// large terms). The tiles come from fused_step_tiles: w pre-scaled by 2 noe
// and pre-masked by bead validity, nb the pre-masked vdw predicate. Every
// product and sum of the pair terms is an fmaf or a never-fused intrinsic,
// so a row's bits do not depend on which of a warp's rows it is.
//
// What bounds it on an H100: a step at the main path's shape (B = 20 then
// 10, L = 512) is 5.2M (then 2.6M) pairs, microseconds of work, so one launch
// a step was bound by what surrounds the arithmetic: the launch and the
// host's loop (a step every ~65 us), three (L, L) tile rows re-read from L2
// by every structure, and a per-warp serial tail (22.3 and 10.7 us of device
// time a step). This kernel takes 9.6-9.7 us a step at B = 20 and 7.3-7.7 us
// at B = 10 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py,
// scripts/profile_torch_solve.py), against a bound of 2.5 us of FP32 work at
// B = 20. By part, at B = 10 (scripts/fused_steps_probe_torch.py --parts):
// the sweep and fold 3.3 us (24.5 SASS instructions a pair with no global
// load, 1.7 x the SM's issue floor), staging x from L2 1.8 us (all 128
// blocks ask at once, each line wanted by every block of its structure
// group), the grid barrier 1.4 us, the update 0.7 us, the energies 0.1 us.
// Design:
//  - A persistent grid launched with cudaLaunchCooperativeKernel (all blocks
//    co-resident, one 256-thread block an SM) walks the steps. Block
//    (row group, structure group) owns 8 x RPW bead rows for its structures
//    for the whole launch; warp w owns RPW consecutive rows. (Two variants
//    were built and measured and are not kept: sixteen warps a block, two
//    sharing a row's columns, was no faster — the sweep is bound by the SM's
//    issue rate, not by latency — and the 128-register cap spilled; two
//    128-thread blocks an SM with a barrier per structure group, to hide one
//    group's barrier behind the other's arithmetic, doubled the blocks that
//    stage x from L2 and was 15-20% slower.)
//  - Resident mode (L <= 768): a lane keeps its rows' t, w and nb at columns
//    lane + 32 m in registers for the whole launch — the tiles are read from
//    memory once a launch, not once a structure a step. Streamed mode (longer
//    L, or more row groups than SMs): the same loop reloads the tile
//    registers per 256-column chunk and walks several row groups a block.
//  - Chromosomes: a structure group never holds two chromosomes' structures,
//    so one tile set serves a block's group. Resident mode needs a block for
//    every row group of every chromosome (C x nrg <= SMs: C <= 4 at L = 512);
//    past that the launch streams and a block walks structure groups too
//    (the genome bucket, 45 x 32 row groups: 128 blocks, 16 along the groups
//    x 8 along the row groups, a group a whole chromosome). There the tiles,
//    45 x 3 MiB, are re-read every step and do not fit L2. Measured at 45
//    chromosomes, L = 512: 0.473 ms a step at 20 structures each, 0.267 at 10
//    (4.2 and 4.7 x the FP32 bound; 45 x a lone resident launch's step,
//    0.43 and 0.34; NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py).
//  - x is double-buffered in global memory. Each step a block stages its
//    structures' old x into shared memory as float4 (one LDS.128 per column
//    serves RPW pairs), sweeps the pairs, folds the row sums with the
//    multi-value butterfly of warp_fold.cuh (the fold of one structure in one
//    block of straight-line code with the pairs of the next), and then
//    spreads the update over the lanes: one (row, structure, coordinate) each — bond from the staged
//    old x, clip, Adam, four noise hashes, the move — writing x' to the
//    other buffer. mu and nu stay in shared memory between steps (resident
//    mode; updated in place in global memory when streamed).
//  - Steps are separated by a grid-wide barrier, cooperative groups'
//    grid.sync() (1.16 us a turn on 128 blocks against 1.35 us for a
//    hand-written counter barrier, NVIDIA H100 80GB HBM3, 700.00 W,
//    scripts/fused_steps_probe_torch.py); x is read with ld.cg (L2), since a
//    buffer is rewritten every other step.
//  - Energies: each block adds its rows' energies per structure, 8 rows at
//    a time in a fixed order, into part[k, b, 8-row group]; after the last
//    step (one more grid barrier) the grid sums each structure's groups in
//    order into hist[k, b]. The partials do not depend on RPW or the grid,
//    so a chromosome's history is its own launch's. No float atomics: two
//    launches from one state give equal bits.
//
// The per-bead half (bond, clip, Adam, noise, move) and the noise's bit
// contract live in step_common.cuh, shared with kernel B4.
//
// The three tiles are float32 or bfloat16 (AnnealConfig.pair_bf16: the JAX
// solver casts fused_step_tiles to bf16 after the fold, and
// `_kernel_fused_step` converts on read, pallas_energy.py:436-440). The
// kernel is a template on their type and widens each element as it loads
// the tile registers (tile_load.cuh): once a launch in the resident mode,
// every chunk in the streamed mode, where bf16 halves the tiles re-read a
// step (the genome bucket's 45 x 3 MiB). The plan does not look at the type,
// so a bf16 launch gives the float32 launch's bits on the widened tiles.

#include <cooperative_groups.h>

#include "step_common.cuh"
#include "tile_load.cuh"
#include "warp_fold.cuh"

namespace cg = cooperative_groups;

namespace {

using c3d::kEps;
using c3d::kThreads;
using c3d::kWarps;
using c3d::StepParams;

struct StepsArgs {
  float* xA;            // (B, 3, L): step k0 reads xA and writes xB, k0 + 1 back
  float* xB;
  float* mu;            // (B, 3, L) in and out
  float* nu;
  const void* t;        // (C, L, L) targets, one tile set a chromosome
  const void* w;        // (C, L, L) 2 noe w pv
  const void* nb;       // (C, L, L) vdw predicate; all three of the tile type
  const float* bm;      // (C, L) bead masks
  const int* seeds;     // (C,) noise seeds, one a chromosome
  const float* table;   // row of step k0; kTableCols floats a row
  float* part;          // (k1 - k0, B, nrg x RPW) energy partials of 8 rows each
  float* hist;          // (k1 - k0, B) energies out
  int B, L, k0, k1;
  int n_per;            // structures a chromosome: B = C x n_per, chromosome-major
  int nsgc;             // structure groups a chromosome
  int nsg;              // structure groups in all (C x nsgc)
  int nsgb;             // blocks along the groups (grid = nsgb x nrgb); a block
                        // walks groups sgb, sgb + nsgb, ... (resident: nsgb = nsg)
  int nrgb;             // blocks along the row groups
  int nrg;              // row groups of 8 x RPW rows
  int sg;               // structures a group
  int sp;               // structures a pass (staged together)
  int lx;               // staged columns a structure (a multiple of 32 x CPL)
  float b1, b2, eps_adam, bond_w, bond_len, clip;
};

// Structure group sgi: chromosome c's structures [b0, b1). A group never
// holds two chromosomes' structures, so a block's tile rows (in registers in
// the resident mode) serve all of it.
struct Group {
  int c, b0, b1;
};

__device__ __forceinline__ Group group_of(const StepsArgs& a, int sgi) {
  const int c = sgi / a.nsgc;
  const int b0 = c * a.n_per + (sgi % a.nsgc) * a.sg;
  return {c, b0, min(b0 + a.sg, (c + 1) * a.n_per)};
}

// np structures' old x, (np, 3, L) contiguous in global memory, into the
// float4 staging area. The loads of a batch of 15 rows (5 structures) x JU
// columns a thread are all issued before the first store: a load issued
// after a shared-memory store would wait for the one before it (the source
// pointer is generic), and a step would pay an L2 round trip per load
// instead of one per batch. ld.cg reads L2: the buffer was written by other
// blocks one step ago and held other values two steps ago.
template <int JU>
__device__ __forceinline__ void stage_x(const float* src, float4* xs, int np, int L,
                                        int lx, int tid) {
  constexpr int NB = 15;
  const int rows = 3 * np;
  for (int jb = 0; jb < L; jb += kThreads * JU) {
    for (int r0 = 0; r0 < rows; r0 += NB) {
      float buf[NB][JU];
#pragma unroll
      for (int q = 0; q < NB; ++q) {
#pragma unroll
        for (int u = 0; u < JU; ++u) {
          const int j = jb + tid + kThreads * u;
          buf[q][u] = (r0 + q < rows && j < L) ? __ldcg(src + (size_t)(r0 + q) * L + j) : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < NB; q += 3) {   // one float4 a structure and column
#pragma unroll
        for (int u = 0; u < JU; ++u) {
          const int j = jb + tid + kThreads * u;
          if (r0 + q < rows && j < L)
            xs[(size_t)((r0 + q) / 3) * lx + j] =
                make_float4(buf[q][u], buf[q + 1][u], buf[q + 2][u], 0.f);
        }
      }
    }
  }
}

// With -DC3D_STEPS_TIMING (scripts/fused_steps_probe_torch.py builds its own
// library so) thread 0 of every block adds up the SM cycles it spends in each
// part of a step; the production build has none of this.
#ifdef C3D_STEPS_TIMING
constexpr int kTimingParts = 6, kTimingBlocks = 256;
__device__ long long c3d_steps_timing[kTimingBlocks * kTimingParts];
#define C3D_TICK(i)                      \
  if (threadIdx.x == 0) {                \
    const long long now = clock64();     \
    spent[i] += now - last;              \
    last = now;                          \
  }
#else
#define C3D_TICK(i)
#endif

__device__ __forceinline__ float pick3(int c, float x, float y, float z) {
  return c == 0 ? x : (c == 1 ? y : z);
}

// chromosome c's rows i0 .. i0 + RPW - 1 at columns c0 + lane + 32 m,
// widened from the tile type TT; 0 past the edge
template <int CPL, int RPW, typename TT>
__device__ __forceinline__ void load_tiles(const StepsArgs& a, int c, int i0, int c0,
                                           int lane, float (&t)[RPW][CPL],
                                           float (&w)[RPW][CPL], float (&nb)[RPW][CPL]) {
  const size_t base = (size_t)c * a.L * a.L;
  const TT* at = static_cast<const TT*>(a.t);
  const TT* aw = static_cast<const TT*>(a.w);
  const TT* anb = static_cast<const TT*>(a.nb);
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
#pragma unroll
    for (int m = 0; m < CPL; ++m) {
      const int i = i0 + rr, j = c0 + lane + 32 * m;
      const bool ok = i < a.L && j < a.L;
      const size_t idx = base + (ok ? (size_t)i * a.L + j : 0);
      t[rr][m] = ok ? c3d::tile_ldg(at + idx) : 0.f;
      w[rr][m] = ok ? c3d::tile_ldg(aw + idx) : 0.f;
      nb[rr][m] = ok ? c3d::tile_ldg(anb + idx) : 0.f;
    }
  }
}

template <int CPL, int RPW, bool RESIDENT, typename TT>
__global__ void __launch_bounds__(kThreads, 1) fused_steps_kernel(const StepsArgs a) {
  extern __shared__ float4 smem[];
  constexpr int R = kWarps * RPW, CHUNK = 32 * CPL, NV = 4 * RPW;
  constexpr int JU = CPL >= 24 ? 3 : (CPL >= 16 ? 2 : 1);   // resident: 256 JU >= L
  static_assert(RPW == 1 || RPW == 2, "the update's job index assumes 1 or 2 rows a warp");
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.L;
  float4* xs = smem;                                       // [sp][lx]
  float* sums = reinterpret_cast<float*>(xs + (size_t)a.sp * a.lx);
  float* wsum = sums + warp * RPW * a.sp * 4;              // this warp's [RPW][np][4]
  float* mom = sums + kWarps * RPW * a.sp * 4;             // resident: [R][nsb][3][2]
  const int sgb = blockIdx.x % a.nsgb, rgb = blockIdx.x / a.nsgb;
  // the resident mode's one group (its tiles in registers, mu and nu in
  // shared memory); the streamed mode walks groups sgb, sgb + nsgb, ...
  const Group g0 = group_of(a, sgb);
  const int nsb = max(g0.b1 - g0.b0, 0);

  // columns past L stay 0 for the whole launch (their tile values are 0)
  for (int q = tid; q < a.sp * a.lx; q += kThreads) xs[q] = make_float4(0.f, 0.f, 0.f, 0.f);

  int which;
  bool owner;
  c3d::fold_all_id<16, NV>(lane, which, owner);

  float t[RPW][CPL], w[RPW][CPL], nb[RPW][CPL];
  if (RESIDENT) {
    load_tiles<CPL, RPW, TT>(a, g0.c, rgb * R + warp * RPW, 0, lane, t, w, nb);
    for (int q = tid; q < R * nsb * 3; q += kThreads) {
      const int c = q % 3, s = (q / 3) % nsb, i = rgb * R + q / (3 * nsb);
      const size_t g = ((size_t)(g0.b0 + s) * 3 + c) * L + i;
      mom[2 * q] = i < L ? a.mu[g] : 0.f;
      mom[2 * q + 1] = i < L ? a.nu[g] : 0.f;
    }
  }

  // the step's row of the table, loaded a step ahead: the load is in flight
  // across the grid barrier instead of stalling the first use after it
  float row[c3d::kTableCols];
#pragma unroll
  for (int q = 0; q < c3d::kTableCols; ++q) row[q] = __ldg(a.table + q);

#ifdef C3D_STEPS_TIMING
  long long spent[kTimingParts] = {0, 0, 0, 0, 0, 0};
  long long last = clock64();
#endif
  for (int k = a.k0; k < a.k1; ++k) {
    const int kk = k - a.k0;
    StepParams p;
    p.lr = row[0];
    p.sigma = row[1];
    p.vdw = row[2];
    p.vdw_radius = row[3];
    p.bc1 = row[4];
    p.bc2 = row[5];
    p.b1 = a.b1;
    p.b2 = a.b2;
    p.eps_adam = a.eps_adam;
    p.bond_w = a.bond_w;
    p.bond_len = a.bond_len;
    p.clip = a.clip;
    p.step = (uint32_t)k;
    const float half_vdw = 0.5f * p.vdw, neg_two_vdw = -2.0f * p.vdw, r0 = p.vdw_radius;
    const float* xin = (kk & 1) ? a.xB : a.xA;
    float* xout = (kk & 1) ? a.xA : a.xB;

    // the groups this block walks (resident: its one, known at compile time,
    // so the loop adds no live registers to the variants that hold tiles)
    const int ngb = RESIDENT ? 1 : (a.nsg - sgb + a.nsgb - 1) / a.nsgb;
    for (int gi = 0; gi < ngb; ++gi) {
      const Group grp = RESIDENT ? g0 : group_of(a, sgb + gi * a.nsgb);
      for (int p0 = grp.b0; p0 < grp.b1; p0 += a.sp) {
        const int np = min(a.sp, grp.b1 - p0);
        __syncthreads();   // the last pass's readers of xs and sums are done
        stage_x<JU>(xin + (size_t)p0 * 3 * L, xs, np, L, a.lx, tid);
        __syncthreads();
        C3D_TICK(0)   // staged

        for (int rg = rgb; rg < a.nrg; rg += a.nrgb) {
          const int i0 = rg * R + warp * RPW;
          for (int q = lane; q < RPW * np * 4; q += 32) wsum[q] = 0.f;
          __syncwarp();

          // ---- pair sweep: lanes stride the columns, tiles in registers ----
          for (int c0 = 0; c0 < L; c0 += CHUNK) {
            if (!RESIDENT) load_tiles<CPL, RPW, TT>(a, grp.c, i0, c0, lane, t, w, nb);
            // structure s's row sums, this lane's columns
            auto pairs = [&](int s, float (&v)[NV]) {
              const float4* xb = xs + (size_t)s * a.lx;
              float4 xi[RPW];
#pragma unroll
              for (int rr = 0; rr < RPW; ++rr) xi[rr] = xb[min(i0 + rr, L - 1)];
#pragma unroll
              for (int q = 0; q < NV; ++q) v[q] = 0.f;
#pragma unroll
              for (int m = 0; m < CPL; ++m) {
                const float4 xj = xb[c0 + lane + 32 * m];
#pragma unroll
                for (int rr = 0; rr < RPW; ++rr) {
                  const float dx = __fsub_rn(xi[rr].x, xj.x);
                  const float dy = __fsub_rn(xi[rr].y, xj.y);
                  const float dz = __fsub_rn(xi[rr].z, xj.z);
                  const float s2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, kEps)));
                  const float rinv = c3d::rsqrt_fast(s2);
                  const float u = fmaf(-t[rr][m], rinv, 1.0f);
                  const float wtu = __fmul_rn(w[rr][m], u);
                  const float vv = fmaxf(fmaf(r0, rinv, -1.0f), 0.f);
                  const float nv = __fmul_rn(nb[rr][m], vv);
                  const float ee = fmaf(0.25f, __fmul_rn(wtu, u),
                                        __fmul_rn(half_vdw, __fmul_rn(nv, vv)));
                  v[4 * rr] = fmaf(s2, ee, v[4 * rr]);
                  const float cf = fmaf(neg_two_vdw, nv, wtu);
                  v[4 * rr + 1] = fmaf(cf, dx, v[4 * rr + 1]);
                  v[4 * rr + 2] = fmaf(cf, dy, v[4 * rr + 2]);
                  v[4 * rr + 3] = fmaf(cf, dz, v[4 * rr + 3]);
                }
              }
            };
            // folds them over the lanes into the warp's sums
            auto fold_out = [&](int s, float (&v)[NV]) {
              c3d::fold_all<16>(v, lane);
              if (owner) wsum[((which >> 2) * np + s) * 4 + (which & 3)] += v[0];
            };
            // the fold of structure s - 1, a chain of shuffles, shares one
            // block of straight-line code with the pairs of structure s
            float vp[NV];
            pairs(0, vp);
            for (int s = 1; s < np; ++s) {
              float v[NV];
              pairs(s, v);
              fold_out(s - 1, vp);
#pragma unroll
              for (int q = 0; q < NV; ++q) vp[q] = v[q];
            }
            fold_out(np - 1, vp);
          }
          __syncwarp();
          C3D_TICK(1)   // swept and folded

          // ---- update: one (row, structure, coordinate) a lane ----
          for (int job = lane; job < RPW * np * 3; job += 32) {
            const int c = job % 3, rs = job / 3;
            const int rr = (RPW > 1 && rs >= np) ? 1 : 0, s = rs - rr * np;   // RPW <= 2
            const int i = i0 + rr;
            if (i >= L) continue;
            const float4* xb = xs + (size_t)s * a.lx;
            const float4 a4 = xb[i];
            const float av[3] = {a4.x, a4.y, a4.z};
            const float* bm = a.bm + (size_t)grp.c * L;   // the chromosome's mask
            const float bmi = __ldg(bm + i);
            float fwd[3] = {0.f, 0.f, 0.f}, fwd_prev[3] = {0.f, 0.f, 0.f};
            float e_bond = 0.f;
            if (i + 1 < L) {   // bond i -> i+1, owned by bead i
              const float4 n4 = xb[i + 1];
              const float nx[3] = {n4.x, n4.y, n4.z};
              e_bond = c3d::bond_forward(av, nx, bmi * __ldg(bm + i + 1), p, fwd);
            }
            if (i > 0) {       // bond i-1 -> i: bead i is its "+1" end
              const float4 p4 = xb[i - 1];
              const float pv[3] = {p4.x, p4.y, p4.z};
              c3d::bond_forward(pv, av, __ldg(bm + i - 1) * bmi, p, fwd_prev);
            }
            float* sm = wsum + (rr * np + s) * 4;
            float gr[3];
#pragma unroll
            for (int cc = 0; cc < 3; ++cc) gr[cc] = sm[1 + cc] + (fwd_prev[cc] - fwd[cc]);
            const float scale = c3d::clip_scale(gr, p);
            float g = pick3(c, gr[0], gr[1], gr[2]);
            if (p.clip > 0.f) g = g * scale;
            const int bg = p0 + s;
            const size_t gidx = ((size_t)bg * 3 + c) * L + i;
            float* mm = mom + 2 * (((warp * RPW + rr) * nsb + (bg - grp.b0)) * 3 + c);
            float mu = RESIDENT ? mm[0] : a.mu[gidx];
            float nu = RESIDENT ? mm[1] : a.nu[gidx];
            // the chromosome's noise stream, its structures numbered from 0
            // as in a launch of its own
            p.seed = (uint32_t)__ldg(a.seeds + grp.c);
            xout[gidx] = c3d::adam_move(pick3(c, av[0], av[1], av[2]), g, mu, nu, bmi,
                                        (uint32_t)(i * 3 + c),
                                        c3d::noise_base(p, bg - grp.c * a.n_per), p);
            if (RESIDENT) {
              mm[0] = mu;
              mm[1] = nu;
            } else {
              a.mu[gidx] = mu;
              a.nu[gidx] = nu;
            }
            if (c == 0) sm[0] = sm[0] + e_bond;
          }
          C3D_TICK(2)   // updated
          __syncthreads();
          C3D_TICK(3)   // the block's other warps are done

          // ---- each 8 rows' energy per structure, rows in order: the
          // partials do not depend on RPW (warps 4h .. 4h + 3 own rows
          // 8h .. 8h + 7 when RPW = 2) ----
          if (tid < RPW * np) {
            const int s = tid % np, h = tid / np;
            float e = 0.f;
            for (int wq = h * (kWarps / RPW); wq < (h + 1) * (kWarps / RPW); ++wq)
              for (int rr = 0; rr < RPW; ++rr)
                e += sums[wq * RPW * a.sp * 4 + (rr * np + s) * 4];
            a.part[((size_t)kk * a.B + p0 + s) * (a.nrg * RPW) + rg * RPW + h] = e;
          }
          if (rg + a.nrgb < a.nrg) __syncthreads();   // before the next group zeroes sums
          C3D_TICK(4)   // energies out
        }
      }
    }
    if (k + 1 < a.k1) {
#pragma unroll
      for (int q = 0; q < c3d::kTableCols; ++q)
        row[q] = __ldg(a.table + (size_t)(kk + 1) * c3d::kTableCols + q);
      grid.sync();   // every block's x' is written and visible
    }
    C3D_TICK(5)   // through the grid barrier
  }
#ifdef C3D_STEPS_TIMING
  if (tid == 0 && blockIdx.x < kTimingBlocks)
    for (int q = 0; q < kTimingParts; ++q)
      c3d_steps_timing[blockIdx.x * kTimingParts + q] = spent[q];
#endif

  if (RESIDENT) {
    __syncthreads();
    for (int q = tid; q < R * nsb * 3; q += kThreads) {
      const int c = q % 3, s = (q / 3) % nsb, i = rgb * R + q / (3 * nsb);
      if (i < L) {
        const size_t g = ((size_t)(g0.b0 + s) * 3 + c) * L + i;
        a.mu[g] = mom[2 * q];
        a.nu[g] = mom[2 * q + 1];
      }
    }
  }

  // every step's energy per structure: its 8-row partials in order (past L
  // they are 0), whatever blocks wrote them, so a structure's history does
  // not depend on the grid, RPW or the chromosomes beside it
  grid.sync();
  const int nk = (a.k1 - a.k0) * a.B, ne = a.nrg * RPW;
  for (int q = blockIdx.x * kThreads + tid; q < nk; q += gridDim.x * kThreads) {
    const float* pq = a.part + (size_t)q * ne;
    float e = 0.f;
    for (int r = 0; r < ne; ++r) e += __ldcg(pq + r);
    a.hist[q] = e;
  }
}

template <int CPL, int RPW, bool RESIDENT, typename TT>
int occupancy(size_t smem, int* slots) {
  auto kern = fused_steps_kernel<CPL, RPW, RESIDENT, TT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  *slots = per_sm * n_sm;
  return 0;
}

template <int CPL, int RPW, bool RESIDENT, typename TT>
int launch(const StepsArgs& a, size_t smem, cudaStream_t stream) {
  const int blocks = a.nsgb * a.nrgb;
  if (a.lx % (32 * CPL) != 0 || a.lx < a.L || a.n_per < 1 || a.B % a.n_per != 0 ||
      a.nsgc * a.sg < a.n_per || a.nsg != (a.B / a.n_per) * a.nsgc || a.nsgb < 1 ||
      a.nsgb > a.nsg || a.sp < 1 || a.nrg * kWarps * RPW < a.L || a.nrgb > a.nrg ||
      (RESIDENT && (a.nrgb != a.nrg || a.nsgb != a.nsg || a.L > 32 * CPL)))
    return (int)cudaErrorInvalidValue;
  int slots = 0;
  const int rc = occupancy<CPL, RPW, RESIDENT, TT>(smem, &slots);
  if (rc != 0) return rc;
  // every block must be resident at once: the steps meet at a grid barrier
  if (blocks > slots) return (int)cudaErrorCooperativeLaunchTooLarge;
  StepsArgs args = a;
  void* params[] = {&args};
  auto kern = fused_steps_kernel<CPL, RPW, RESIDENT, TT>;
  return (int)cudaLaunchCooperativeKernel((void*)kern, dim3(blocks), dim3(kThreads),
                                          params, smem, stream);
}

// the compiled (columns a lane, rows a warp, resident) variants
#define C3D_STEPS_VARIANTS(X) \
  X(16, 1, true) X(16, 2, true) X(24, 1, true) X(24, 2, true) X(8, 2, false)

// one launch of the variant the plan names, on tiles of type TT
template <typename TT>
int steps_entry(float* xA, float* xB, float* mu, float* nu, const TT* t, const TT* w,
                const TT* nb, const float* bm, const int* seeds, const float* table,
                float* part, float* hist, int B, int L, int k0, int k1, int n_per, int cpl,
                int rpw, int resident, int nsgc, int nsgb, int nrgb, int nrg, int sg,
                int sp, int lx, int smem_bytes, float b1, float b2, float eps_adam,
                float bond_w, float bond_len, float clip, void* stream) {
  if (n_per < 1 || B % n_per != 0) return (int)cudaErrorInvalidValue;
  const StepsArgs a{xA, xB, mu, nu, t, w, nb, bm, seeds, table, part, hist,
                    B, L, k0, k1, n_per, nsgc, (B / n_per) * nsgc, nsgb, nrgb, nrg,
                    sg, sp, lx, b1, b2, eps_adam, bond_w, bond_len, clip};
#define X(CPL, RPW, RES)                                     \
  if (cpl == CPL && rpw == RPW && (resident != 0) == RES)    \
    return launch<CPL, RPW, RES, TT>(a, (size_t)smem_bytes, (cudaStream_t)stream);
  C3D_STEPS_VARIANTS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// B = C x n_per structures, chromosome-major; t, w, nb (C, L, L), bm (C, L),
// seeds (C,); C = 1 is a batch sharing one restraint set. part: (k1 - k0, B, nrg x rpw) scratch;
// hist: (k1 - k0, B) out. The _bf16 entry takes bfloat16 t, w and nb,
// everything else as the float32 one.
extern "C" int c3d_fused_steps(float* xA, float* xB, float* mu, float* nu, const float* t,
                               const float* w, const float* nb, const float* bm,
                               const int* seeds, const float* table, float* part,
                               float* hist, int B, int L, int k0, int k1, int n_per,
                               int cpl, int rpw, int resident, int nsgc, int nsgb,
                               int nrgb, int nrg, int sg, int sp, int lx,
                               int smem_bytes, float b1, float b2, float eps_adam,
                               float bond_w, float bond_len, float clip, void* stream) {
  return steps_entry(xA, xB, mu, nu, t, w, nb, bm, seeds, table, part, hist, B, L, k0, k1,
                     n_per, cpl, rpw, resident, nsgc, nsgb, nrgb, nrg, sg, sp, lx,
                     smem_bytes, b1, b2, eps_adam, bond_w, bond_len, clip, stream);
}

extern "C" int c3d_fused_steps_bf16(float* xA, float* xB, float* mu, float* nu,
                                    const __nv_bfloat16* t, const __nv_bfloat16* w,
                                    const __nv_bfloat16* nb, const float* bm,
                                    const int* seeds, const float* table, float* part,
                                    float* hist, int B, int L, int k0, int k1, int n_per,
                                    int cpl, int rpw, int resident, int nsgc, int nsgb,
                                    int nrgb, int nrg, int sg, int sp, int lx,
                                    int smem_bytes, float b1, float b2, float eps_adam,
                                    float bond_w, float bond_len, float clip,
                                    void* stream) {
  return steps_entry(xA, xB, mu, nu, t, w, nb, bm, seeds, table, part, hist, B, L, k0, k1,
                     n_per, cpl, rpw, resident, nsgc, nsgb, nrgb, nrg, sg, sp, lx,
                     smem_bytes, b1, b2, eps_adam, bond_w, bond_len, clip, stream);
}

#ifdef C3D_STEPS_TIMING
// the last launch's cycles per block and part: (kTimingBlocks, kTimingParts)
extern "C" int c3d_fused_steps_timing(long long* host_out) {
  return (int)cudaMemcpyFromSymbol(host_out, c3d_steps_timing, sizeof(c3d_steps_timing));
}
#endif

// blocks of this variant the card holds at once with smem_bytes of dynamic
// shared memory each; negative: minus the CUDA error
extern "C" int c3d_fused_steps_slots(int cpl, int rpw, int resident, int smem_bytes) {
  int slots = 0, rc = (int)cudaErrorInvalidValue;
#define X(CPL, RPW, RES)                                  \
  if (cpl == CPL && rpw == RPW && (resident != 0) == RES) \
    rc = occupancy<CPL, RPW, RES, float>((size_t)smem_bytes, &slots);
  C3D_STEPS_VARIANTS(X)
#undef X
  return rc != 0 ? -rc : slots;
}
