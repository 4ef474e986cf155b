// Multi-value butterfly sums, asynchronous copies and the fixed-order block
// sum shared by the pair bodies (general_pair.cu, tri_pair.cuh,
// exact_pair.cu) and kernel B1 (fused_steps.cu).
//
// A thread that holds N partial sums to be added over the lanes of a warp
// would spend N x 5 shuffles on N separate butterflies. `fold` instead halves
// the values at every stage: of each pair (i, i + M / 2) a lane keeps one
// and hands the other to its partner lane ^ OFF, which does the reverse, so
// one shuffle serves two values; an odd last value is summed on both lanes.
// After the stages OFF = 16, 8, 4, 2, 1 every lane holds one value in v[0]
// (13 values cost 6 + 1, 3 + 1, 2, 1, 1 = 15 shuffles, not 65). Every value
// is summed over the same tree (partners at distance 16, then 8, ... 1),
// whichever slot it started in, and float addition commutes: a value's bits
// do not depend on its slot. `fold_id` runs the same exchange on the slot
// numbers, once per thread, so a lane knows which value it ends up holding
// and whether it is the one lane that owns it (an odd value lands on two).

#pragma once

#include <cuda_runtime.h>

namespace c3d {

constexpr int kThreads = 256;   // threads a block of the pair bodies
constexpr int kWarps = kThreads / 32;

// one stage on the first M of v's values; leaves (M + 1) / 2
template <int M, int OFF, int N>
__device__ __forceinline__ void fold(float (&v)[N], bool up) {
  constexpr int H = M / 2;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = up ? v[i + H] : v[i];
    const float send = up ? v[i] : v[i + H];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
  if (M & 1) {
    const float x = v[M - 1];
    v[H] = x + __shfl_xor_sync(0xffffffffu, x, OFF);
  }
}

// the same stage without the selects, for values laid out so that a lane
// whose bit OFF is set holds the halves swapped: every lane keeps its first
// half and adds its partner's second, which holds the same values
template <int M, int OFF, int N>
__device__ __forceinline__ void fold_swapped(float (&v)[N]) {
  constexpr int H = M / 2;
#pragma unroll
  for (int i = 0; i < H; ++i) v[i] = v[i] + __shfl_xor_sync(0xffffffffu, v[i + H], OFF);
  if (M & 1) {
    const float x = v[M - 1];
    v[H] = x + __shfl_xor_sync(0xffffffffu, x, OFF);
  }
}

template <int M, int OFF, int N>
__device__ __forceinline__ void fold_id(int (&id)[N], bool (&own)[N], bool up) {
  constexpr int H = M / 2;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    id[i] = up ? id[i + H] : id[i];
    own[i] = up ? own[i + H] : own[i];
  }
  if (M & 1) {
    id[H] = id[M - 1];
    own[H] = own[M - 1] && !up;
  }
}

// N values over the 2 x OFF0 lanes that differ in the bits below 2 x OFF0
// (OFF0 = 16: the warp; 8: each half-warp), result in v[0]
template <int OFF0, int N>
__device__ __forceinline__ void fold_all(float (&v)[N], int lane) {
  constexpr int M1 = (N + 1) / 2, M2 = (M1 + 1) / 2, M3 = (M2 + 1) / 2,
                M4 = (M3 + 1) / 2;
  if (OFF0 >= 16) {
    fold<N, 16>(v, lane & 16);
    fold<M1, 8>(v, lane & 8);
    fold<M2, 4>(v, lane & 4);
    fold<M3, 2>(v, lane & 2);
    fold<M4, 1>(v, lane & 1);
  } else {
    fold<N, 8>(v, lane & 8);
    fold<M1, 4>(v, lane & 4);
    fold<M2, 2>(v, lane & 2);
    fold<M3, 1>(v, lane & 1);
  }
}

// which of the N values fold_all leaves in this lane's v[0], and whether
// this lane is the one that owns it
template <int OFF0, int N>
__device__ __forceinline__ void fold_all_id(int lane, int& which, bool& owner) {
  constexpr int M1 = (N + 1) / 2, M2 = (M1 + 1) / 2, M3 = (M2 + 1) / 2,
                M4 = (M3 + 1) / 2;
  int id[N];
  bool own[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    id[i] = i;
    own[i] = true;
  }
  if (OFF0 >= 16) {
    fold_id<N, 16>(id, own, lane & 16);
    fold_id<M1, 8>(id, own, lane & 8);
    fold_id<M2, 4>(id, own, lane & 4);
    fold_id<M3, 2>(id, own, lane & 2);
    fold_id<M4, 1>(id, own, lane & 1);
  } else {
    fold_id<N, 8>(id, own, lane & 8);
    fold_id<M1, 4>(id, own, lane & 4);
    fold_id<M2, 2>(id, own, lane & 2);
    fold_id<M3, 1>(id, own, lane & 1);
  }
  which = id[0];
  owner = own[0];
}

// one float from global to shared memory without passing through a
// register; a false `valid` writes 0 and reads nothing (src-size 0)
__device__ __forceinline__ void copy_async(float* smem_dst, const float* src,
                                           bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one MUFU.RSQ: rsqrtf's default adds a denormal rescue the pair kernels
// (s >= 1e-12) never need
__device__ __forceinline__ float rsqrt_fast(float s) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(s));
  return r;
}

// *out = scale x the sum of n values in a fixed order: thread k adds values
// k, k + 256, ..., then each warp its lanes, then thread 0 the warps in
// order. Called by every thread of a 256-thread block.
__device__ __forceinline__ void block_sum(const float* __restrict__ p, int n,
                                          float scale, float* __restrict__ out) {
  __shared__ float sums[kWarps];
  float v = 0.f;
  for (int k = threadIdx.x; k < n; k += kThreads) v += p[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) t += sums[wi];
    *out = scale * t;
  }
}

}  // namespace c3d
