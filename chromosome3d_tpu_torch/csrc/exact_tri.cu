// Kernel B3: the exact-restraint pair energy and gradient with each
// unordered (TM, TM) tile pair computed once, for a batch of structures
// sharing one restraint set.
//
// Replaces: chromosome3d_tpu/ops/pallas_energy.py `_kernel_exact_tri`
// (entry `pallas_energy_grad_tri_batched`). On the port's semi route it
// runs every step before kernel B4 (fused_update.cu), and once more for the
// enantiomer pick at L >= 1024: at the at-scale shape B = 20 then 10
// structures, L = 5120, T = 80 tiles of 64.
//
// Pairing and math: the tile-pair body in tri_pair.cuh, shared with the
// strip kernel B6 (exact_tri_strip.cu), here over all T row tiles.
//
// What bounds it on an H100: instruction issue on the FP32 pipes — 22
// arithmetic instructions and one MUFU rsqrt per unordered pair, B x L^2 / 2
// pairs a call (262M at B = 20, L = 5120), and the folds, loads and stores
// around them (28.0 SASS a pair in all); the two (L, L) tiles (210 MB, read
// once a call) move in a fifth of that time. Design: one 256-thread block
// per tile pair (i, s) with a 4 x 4 register patch of the tiles reused for
// all B structures, coordinates staged in shared memory and no barrier or
// global load in the loop over structures, and the first stage of each fold
// free of selects (tri_pair.cuh's swapped-patch body; the tile staged in
// shared memory for larger patches measured slower, PERF.md §6);
// partials in a (B, 2S, 3, Lp) buffer — row partials of shell s at slot s,
// column partials at slot S + s at their column tile — that a second kernel
// sums per bead in slot order. No float atomics: the same inputs give the
// same bits, so a solve with a fixed seed is reproducible.
//
// The chromosome axis: a genome bucket's C chromosomes of B structures each
// (the JAX runner's vmap of the solve over its bucket) in one launch, grid
// row y the chromosome. Chromosome c's blocks read its structures, tiles and
// mask and write its partials at c's offsets (tri_pair.cuh), and the reduce
// kernel sums each (chromosome, structure) over the same slots in the same
// order as a launch of its own, so chromosome c's bits are that launch's.
//
// The _bf16 entry point takes bfloat16 t and w (AnnealConfig.pair_bf16),
// widened as the register patch is filled (tri_pair.cuh): half the tile
// bytes, the float32 entry's bits on the widened tiles.

#include <cuda_runtime.h>

#include "tri_pair.cuh"

namespace {

using c3d::kThreads;
using c3d_tri::TriParams;

constexpr int kTM = 64;         // tile edge

// gT[b, c, l] = sum over the 2S slots in order; e[b] = sum of the blocks'
// energies (block 0 of each structure), in a fixed order. b runs over all C
// B structures, chromosome-major.
__global__ void __launch_bounds__(kThreads)
tri_reduce_kernel(const float* __restrict__ part,    // (C B, 2S, 3, Lp)
                  const float* __restrict__ e_part,  // (C B, nblk)
                  float* __restrict__ gT,            // (C B, 3, L) out
                  float* __restrict__ e,             // (C B,) out
                  int L, int Lp, int S2, int nblk) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx < 3 * L) {
    const int c = idx / L, l = idx - c * L;
    const float* pp = part + ((size_t)b * S2 * 3 + c) * Lp + l;
    float g = 0.f;
    for (int s = 0; s < S2; ++s) g += pp[(size_t)s * 3 * Lp];
    gT[((size_t)b * 3 + c) * L + l] = g;
  }
  if (blockIdx.x != 0) return;
  c3d::block_sum(e_part + (size_t)b * nblk, nblk, 1.0f, e + b);
}

template <typename TT>
int launch_exact_tri(const float* xT, const TT* t, const TT* w, const float* bm,
                     float* part, float* e_part, float* gT, float* e, int C, int B, int L,
                     int T, int tile, int bslice, float noe, float vdw, float vdw_radius,
                     void* stream) {
  if (tile != kTM || T != (L + kTM - 1) / kTM || bslice <= 0 || B <= 0 || C <= 0 ||
      C > 65535 || (long long)C * B > 65535)
    return (int)cudaErrorInvalidValue;
  const int S = T / 2 + 1;
  const TriParams q{B, L, T, T, S, 0, T * kTM, 0, bslice, noe, vdw, vdw_radius, C, L};
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = c3d_tri::launch_pairs<kTM, TT>(xT, t, w, bm, part, e_part, q, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((3 * L + kThreads - 1) / kThreads, C * B);
  tri_reduce_kernel<<<grid, kThreads, 0, st>>>(part, e_part, gT, e, L, T * kTM,
                                               2 * S, T * S);
  return (int)cudaGetLastError();
}

}  // namespace

// xT: (C B, 3, L), chromosome-major; t, w: (C, L, L), float32 (or bfloat16
// for the _bf16 entry); bm: (C, L). part: (C B, 2 S, 3, T tile) scratch and
// e_part: (C B, T S) scratch, both allocated by the caller; T = ceil(L /
// tile), S = T / 2 + 1; each chromosome's structures go through a block
// bslice at a time. Chromosome c's outputs are bitwise those of a launch
// with C = 1 on its own inputs.
extern "C" int c3d_exact_tri(const float* xT, const float* t, const float* w,
                             const float* bm, float* part, float* e_part,
                             float* gT, float* e, int C, int B, int L, int T,
                             int tile, int bslice, float noe, float vdw,
                             float vdw_radius, void* stream) {
  return launch_exact_tri(xT, t, w, bm, part, e_part, gT, e, C, B, L, T, tile, bslice,
                          noe, vdw, vdw_radius, stream);
}

extern "C" int c3d_exact_tri_bf16(const float* xT, const __nv_bfloat16* t,
                                  const __nv_bfloat16* w, const float* bm, float* part,
                                  float* e_part, float* gT, float* e, int C, int B, int L,
                                  int T, int tile, int bslice, float noe, float vdw,
                                  float vdw_radius, void* stream) {
  return launch_exact_tri(xT, t, w, bm, part, e_part, gT, e, C, B, L, T, tile, bslice,
                          noe, vdw, vdw_radius, stream);
}
