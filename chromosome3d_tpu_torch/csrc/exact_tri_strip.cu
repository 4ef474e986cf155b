// Kernel B6: the exact-restraint pair energy and gradient of one shard's
// row strip with each unordered (TM, TM) tile pair of the whole matrix
// computed once across the shards, for C chromosomes of n structures each,
// a restraint strip and a bead mask a chromosome (one chromosome on the
// row-sharded `run` path; a genome bucket's chromosomes past the length
// buckets, the JAX package's vmap of the shard body over them).
//
// Replaces: chromosome3d_tpu/ops/pallas_energy.py `_kernel_exact_tri_strip`
// (entry `pallas_strip_tri_energy_grad_batched`) and the gradient assembly
// `assemble_strip_tri_grad`. On the row-sharded `run` path (exact
// restraints past the largest bucket over several shards) it runs once per
// shard every annealing step, before kernel B4, and once per shard for the
// enantiomer pick: at L = 5120 over 4 shards, Lb = 1280 rows, B = 20 then
// 10 structures. On the genome path past the buckets it runs once a step
// for the whole bucket: C chromosomes of L = 1024-2560 (a genome at
// 100 kb) or 5120 (50 kb), one strip of Lb = L each on one card.
//
// The chromosome axis: grid row y is the chromosome, whose blocks read its
// n structures, strip and mask and write its partials; the assembly runs
// over all C n structures, each from its own partials. A chromosome's
// blocks and sums are those of a launch of its own, so its bits are too.
//
// Pairing and math: the tile-pair body in tri_pair.cuh, shared with B3. The
// strip's row tiles are global tiles row0t .. row0t + Tl - 1; the round-robin
// column tile, the even-Tg dead twin and the |i - j| >= 2 vdw predicate all
// use global indices, so the union over the shards is B3's set of blocks.
// The body writes row partials at the strip's rows and column partials in
// the compact layout (slot i of shell s holds global column tile
// (row0t + i + s) mod Tg, as the Pallas kernel lays them out).
//
// Assembly (second kernel): the shard's (B, 3, L) gradient, which the
// solver sums over the shards. For bead l: the row partials of shells
// 0 .. S-1 if l lies in the strip, then for each shell s the compact column
// slot i = (tile(l) - row0t - s) mod Tg if i < Tl — B3's slot order, so a
// strip with Lb = L gives B3's bits. Energies: B3's fixed-order block sum.
// No float atomics.
//
// What bounds it on an H100: as B3, instruction issue at 22 arithmetic
// instructions and one MUFU rsqrt per unordered pair and the folds around
// them, now B x Lb x L / 2 pairs per shard (65.5M at B = 20, L = 5120, Lb =
// 1280), not the (Lb, L) tiles (52 MB, read once); the body's design is
// tri_pair.cuh's: B3's swapped-patch body at tile 64 (the wrapper counts
// those launches in `.launches_tile64`), the patch body at 32, 16 and 8.
// The tile is the port's own: 64, or the largest of 32, 16 and 8 that
// divides Lb (the JAX package's strip tile is sized for VMEM and may be
// larger; the routing rule is kept, the tile is not).

#include <cuda_runtime.h>

#include "tri_pair.cuh"

namespace {

using c3d::kThreads;
using c3d_tri::TriParams;

__global__ void __launch_bounds__(kThreads)
strip_assemble_kernel(const float* __restrict__ part,    // (C n, 2S, 3, Lb)
                      const float* __restrict__ e_part,  // (C n, nblk)
                      float* __restrict__ gT,            // (C n, 3, L) out
                      float* __restrict__ e,             // (C n,) out
                      int L, int Lb, int tile, int Tl, int Tg, int S, int row0t,
                      int nblk) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx < 3 * L) {
    const int c = idx / L, l = idx - c * L;
    const size_t slot = (size_t)3 * Lb;
    const float* pb = part + (size_t)b * 2 * S * slot + (size_t)c * Lb;
    float g = 0.f;
    const int lr = l - row0t * tile;
    if (lr >= 0 && lr < Lb) {
      for (int s = 0; s < S; ++s) g += pb[s * slot + lr];
    }
    // i falls by one a shell (mod Tg); a shell whose row tile lies outside
    // the strip adds 0, so the loads do not wait on a branch
    const int tl = l / tile, off = l - tl * tile;
    int i = ((tl - row0t) % Tg + Tg) % Tg;
    const float* pc = pb + S * slot + off;
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      g += i < Tl ? pc[s * slot + (size_t)i * tile] : 0.f;
      i = i == 0 ? Tg - 1 : i - 1;
    }
    gT[((size_t)b * 3 + c) * L + l] = g;
  }
  if (blockIdx.x != 0) return;
  c3d::block_sum(e_part + (size_t)b * nblk, nblk, 1.0f, e + b);
}

template <typename TT>
int launch_exact_tri_strip(const float* xT, const TT* t, const TT* w, const float* bm,
                           float* part, float* e_part, float* gT, float* e, int C, int n,
                           int L, int row0, int Lb, int tile, int bslice, float noe,
                           float vdw, float vdw_radius, void* stream) {
  if (tile <= 0 || Lb <= 0 || Lb % tile || L % tile || row0 % tile || row0 < 0 ||
      row0 + Lb > L || bslice <= 0 || n <= 0 || C <= 0 || C > 65535)
    return (int)cudaErrorInvalidValue;
  const int Tl = Lb / tile, Tg = L / tile, S = Tg / 2 + 1;
  const TriParams q{n, L, Tl, Tg, S, row0 / tile, Lb, 1, bslice, noe, vdw, vdw_radius,
                    C, Lb};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (tile) {
    case 64: err = c3d_tri::launch_pairs<64, TT>(xT, t, w, bm, part, e_part, q, st); break;
    case 32: err = c3d_tri::launch_pairs<32, TT>(xT, t, w, bm, part, e_part, q, st); break;
    case 16: err = c3d_tri::launch_pairs<16, TT>(xT, t, w, bm, part, e_part, q, st); break;
    case 8: err = c3d_tri::launch_pairs<8, TT>(xT, t, w, bm, part, e_part, q, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((3 * L + kThreads - 1) / kThreads, C * n);
  strip_assemble_kernel<<<grid, kThreads, 0, st>>>(part, e_part, gT, e, L, Lb, tile,
                                                   Tl, Tg, S, row0 / tile, Tl * S);
  return (int)cudaGetLastError();
}

}  // namespace

// xT: (C n, 3, L), chromosome-major; t, w: each chromosome's strip of
// (Lb, L) rows, global rows row0 .. row0 + Lb - 1, as (C, Lb, L); bm: (C,
// L); tile divides Lb and row0 and L; part: (C n, 2 S, 3, Lb) and e_part:
// (C n, Tl S) scratch allocated by the caller, Tl = Lb / tile, Tg = L /
// tile, S = Tg / 2 + 1; each chromosome's n structures go through a block
// bslice at a time. One launch covers every chromosome; chromosome c's
// outputs are bitwise those of a launch with C = 1 on its own inputs. The
// _bf16 entry takes bfloat16 strips t and w (AnnealConfig.pair_bf16),
// widened on load (tri_pair.cuh): the float32 entry's bits on the widened
// strips.
extern "C" int c3d_exact_tri_strip(const float* xT, const float* t, const float* w,
                                   const float* bm, float* part, float* e_part,
                                   float* gT, float* e, int C, int n, int L, int row0,
                                   int Lb, int tile, int bslice, float noe,
                                   float vdw, float vdw_radius, void* stream) {
  return launch_exact_tri_strip(xT, t, w, bm, part, e_part, gT, e, C, n, L, row0, Lb,
                                tile, bslice, noe, vdw, vdw_radius, stream);
}

extern "C" int c3d_exact_tri_strip_bf16(const float* xT, const __nv_bfloat16* t,
                                        const __nv_bfloat16* w, const float* bm,
                                        float* part, float* e_part, float* gT, float* e,
                                        int C, int n, int L, int row0, int Lb, int tile,
                                        int bslice, float noe, float vdw,
                                        float vdw_radius, void* stream) {
  return launch_exact_tri_strip(xT, t, w, bm, part, e_part, gT, e, C, n, L, row0, Lb,
                                tile, bslice, noe, vdw, vdw_radius, stream);
}
