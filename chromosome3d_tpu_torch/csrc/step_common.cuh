// The per-bead half of an annealing step, shared by kernel B1
// (fused_steps.cu) and kernel B4 (fused_update.cu): chain bond, per-bead
// gradient clip, Adam with the bias corrections passed in, CLT-4 Langevin
// noise and the coordinate move. One source for both kernels, so B4's noise
// and update are B1's by construction (the JAX package shares
// `_t_layout_bond` and `_t_layout_noise` between its two kernels the same
// way, pallas_energy.py:264-327). The pieces (`bond_forward`, `clip_scale`,
// `adam_move`) are what both kernels spread over their lanes, one (bead,
// structure, coordinate) each, composed the same way.
//
// Noise: bitwise equal to _t_layout_noise. Element index row * 3 + coord,
// base = seed + step * 0x9E3779B9 + b * 0x7FEB352D (uint32 wraparound), four
// murmur3-finalised uniforms (h >> 8) * 2^-24 summed in the Pallas order,
// minus 2, times float32(sqrt(3)). Each uniform is an exact float, so a
// contracted multiply-add cannot change the bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace c3d {

constexpr float kEps = 1e-12f;

// One step's scalars: the per-step view of the schedule. B1 and B4 fill it
// from row k of the schedule table (columns lr, sigma, vdw, vdw_radius, bc1,
// bc2) and the solve's constants.
struct StepParams {
  float vdw, vdw_radius, lr, sigma, b1, b2, eps_adam, bc1, bc2;
  float bond_w, bond_len, clip;
  uint32_t seed, step;
};

constexpr int kTableCols = 6;   // lr, sigma, vdw, vdw_radius, bc1, bc2

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float uniform24(uint32_t h) {
  return (float)(int)(mix32(h) >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float clt4_noise(uint32_t elem, uint32_t base) {
  const uint32_t k = elem ^ base;
  float s = uniform24(k ^ 0x68E31DA4u);
  s = s + uniform24(k ^ 0xB5297A4Du);
  s = s + uniform24(k ^ 0x1B56C4E9u);
  s = s + uniform24(k ^ 0x7C15BD3Fu);
  return (s - 2.0f) * 1.7320508075688772f;
}

__device__ __forceinline__ uint32_t noise_base(const StepParams& p, int b) {
  return p.seed + p.step * 0x9E3779B9u + (uint32_t)b * 0x7FEB352Du;
}

// The bond from bead `a` to its chain successor `nx` (both from the OLD x),
// valid = bead_a * bead_nx: fwd = dE/d(nx) (so dE/da = -fwd); returns the
// bond's energy, which belongs to bead `a`.
__device__ __forceinline__ float bond_forward(const float a[3], const float nx[3],
                                              float valid, const StepParams& p,
                                              float fwd[3]) {
  float dn[3];
  for (int c = 0; c < 3; ++c) dn[c] = nx[c] - a[c];
  const float db = sqrtf(dn[0] * dn[0] + dn[1] * dn[1] + dn[2] * dn[2] + kEps);
  const float bdev = db - p.bond_len;
  const float f = 2.0f * p.bond_w * valid * bdev / db;
  for (int c = 0; c < 3; ++c) fwd[c] = f * dn[c];
  return p.bond_w * valid * bdev * bdev;
}

// The factor that brings a bead's gradient to at most p.clip in norm (1
// when the clip is off, p.clip <= 0).
__device__ __forceinline__ float clip_scale(const float gr[3], const StepParams& p) {
  if (!(p.clip > 0.f)) return 1.0f;
  const float gnorm = sqrtf(gr[0] * gr[0] + gr[1] * gr[1] + gr[2] * gr[2] + 1e-12f);
  return fminf(1.0f, p.clip / gnorm);
}

// Adam and the noisy move of one coordinate (element index elem = bead * 3
// + coord) with gradient g: updates mu and nu in place, returns x'.
__device__ __forceinline__ float adam_move(float a, float g, float& mu, float& nu,
                                           float bmi, uint32_t elem, uint32_t base,
                                           const StepParams& p) {
  mu = p.b1 * mu + (1.0f - p.b1) * g;
  nu = p.b2 * nu + (1.0f - p.b2) * g * g;
  const float upd = (mu * p.bc1) / (sqrtf(nu * p.bc2) + p.eps_adam);
  const float noise = clt4_noise(elem, base);
  return a + (-p.lr * upd + p.sigma * noise) * bmi;
}

}  // namespace c3d
