// Restraint-tile elements as the exact pair bodies read them (B1, B2/B2',
// B3, B6): float32 tiles, or bfloat16 tiles (AnnealConfig.pair_bf16),
// widened to float32 on load. Widening is exact, and every body keeps its
// arithmetic in float32 with a plan that does not look at the tile type, so
// a bfloat16 launch gives the bits of the float32 launch on the rounded and
// widened tiles. The replaced Pallas bodies convert the same way on read
// (chromosome3d_tpu/ops/pallas_energy.py:238-241, 436-440, 972-975,
// 1510-1513). Pair loads (__nv_bfloat162) would need a lane to own two
// adjacent columns; every body's lanes stride the columns by 16 or 32, so
// each lane loads single elements and a warp still reads one contiguous run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace c3d {

__device__ __forceinline__ float tile_f32(float v) { return v; }
__device__ __forceinline__ float tile_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// one element through the read-only path, widened
__device__ __forceinline__ float tile_ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float tile_ldg(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

}  // namespace c3d
