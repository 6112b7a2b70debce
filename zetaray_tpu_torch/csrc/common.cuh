// Device helpers shared by the ray-tracing kernels.
//
// Built with --fmad=false and without fast math: each float operation is
// rounded on its own, in the order the PyTorch reference writes it, so the
// Woop edge tests (u >= 0, u + v <= 1) decide the same way on the card as
// in the plain version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define ZR_INF 3.0e38f

namespace zr {

// Triangles stream through shared memory in chunks of this many Woop
// columns. It is also the width of the JAX package's chunks, which fixes
// the closest-hit tie rule (see gbuffer.cu).
constexpr int kTriChunk = 128;
// The 12 Woop coefficients of a chunk: row c*3 + r holds coefficient c
// (x, y, z, translation) of local axis r (u, v, w).
struct WoopChunk {
  float w[12][kTriChunk];
};

// Copies triangles [c0, c0 + kTriChunk) of woop [4, 3, tp] into shared
// memory. Every thread of the block must call it.
__device__ inline void load_woop_chunk(WoopChunk& s, const float* __restrict__ woop,
                                       int tp, int c0) {
  for (int k = threadIdx.x; k < 12 * kTriChunk; k += blockDim.x) {
    const int row = k / kTriChunk;
    const int j = k - row * kTriChunk;
    s.w[row][j] = woop[(size_t)row * tp + c0 + j];
  }
}

// Woop unit-triangle test of triangle j of the chunk. Returns t, or ZR_INF
// when the ray misses it or t lies outside (t_min, t_max).
__device__ __forceinline__ float woop_hit(const WoopChunk& s, int j, float ox, float oy,
                                          float oz, float dx, float dy, float dz,
                                          float t_min, float t_max, float* u_out,
                                          float* v_out) {
  const float dw = s.w[2][j] * dx + s.w[5][j] * dy + s.w[8][j] * dz;
  const bool par = fabsf(dw) < 1e-12f;
  const float ow = s.w[2][j] * ox + s.w[5][j] * oy + s.w[8][j] * oz + s.w[11][j];
  const float t = -ow / (par ? 1.0f : dw);
  if (par || !(t > t_min) || !(t < t_max)) return ZR_INF;
  const float ou = s.w[0][j] * ox + s.w[3][j] * oy + s.w[6][j] * oz + s.w[9][j];
  const float du = s.w[0][j] * dx + s.w[3][j] * dy + s.w[6][j] * dz;
  const float u = ou + t * du;
  if (!(u >= 0.0f)) return ZR_INF;
  const float ov = s.w[1][j] * ox + s.w[4][j] * oy + s.w[7][j] * oz + s.w[10][j];
  const float dv = s.w[1][j] * dx + s.w[4][j] * dy + s.w[7][j] * dz;
  const float v = ov + t * dv;
  if (!(v >= 0.0f) || !(u + v <= 1.0f)) return ZR_INF;
  *u_out = u;
  *v_out = v;
  return t;
}

}  // namespace zr
