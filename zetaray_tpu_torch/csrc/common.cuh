// Device helpers shared by the ray-tracing kernels.
//
// Built with --fmad=false and without fast math: each float operation is
// rounded on its own, in the order the PyTorch reference writes it, so the
// Woop edge tests (u >= 0, u + v <= 1) decide the same way on the card as
// in the plain version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "layout.h"  // LSET_ROWS, LSET_STAGED

#define ZR_INF 3.0e38f

namespace zr {

// pcg4d (Jarzynski & Olano 2020) on four u32 counters, in place: the hash of
// zetaray_tpu_torch.core.rng.pcg4d_lanes, bit for bit.
__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  a = a * 1664525u + 1013904223u;
  b = b * 1664525u + 1013904223u;
  c = c * 1664525u + 1013904223u;
  d = d * 1664525u + 1013904223u;
  a += b * d; b += c * a; c += a * b; d += b * c;
  a ^= a >> 16; b ^= b >> 16; c ^= c >> 16; d ^= d >> 16;
  a += b * d; b += c * a; c += a * b; d += b * c;
}

// Top 24 bits of a u32 as a float in [0, 1) (core.rng.to_unit_float).
__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// Copies rows 0 .. LSET_STAGED-1 (pos, ng, Le, pdf, two-sided) of light set
// `set` of sets [n_sets, LSET_ROWS, ps] into shared memory [LSET_STAGED][ps].
// Every thread of the block must call it.
__device__ inline void stage_light_set(float* s, const float* __restrict__ sets, int set,
                                       int ps) {
  const float* src = sets + (size_t)set * LSET_ROWS * ps;
  for (int k = threadIdx.x; k < LSET_STAGED * ps; k += blockDim.x) s[k] = src[k];
}

// The width of the JAX bounce and G-buffer kernels' triangle chunks, which
// fixes their closest-hit tie rule: the tie group of B1, B4 and B6
// (sweep.cuh closest_sweep).
constexpr int kTriChunk = 128;

}  // namespace zr
