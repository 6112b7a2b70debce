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

// Triangles stream through shared memory in chunks of this many Woop
// columns. It is also the width of the JAX bounce and G-buffer kernels'
// chunks, which fixes their closest-hit tie rule (see closest_hit).
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

// Woop unit-triangle test of triangle j of a coefficient table whose row q
// (coefficient c = q / 3 -- x, y, z, translation -- of local axis r = q % 3)
// starts at w + q * stride: a chunk in shared memory (stride kTriChunk) or
// the whole woop [4, 3, tp] table (stride tp). Returns t, or ZR_INF when the
// ray misses the triangle or t lies outside (t_min, t_max).
__device__ __forceinline__ float woop_test(const float* __restrict__ w, size_t stride, int j,
                                           float ox, float oy, float oz, float dx, float dy,
                                           float dz, float t_min, float t_max, float* u_out,
                                           float* v_out) {
  const float* c = w + j;
#define ZR_W(q) c[(q) * stride]
  const float dw = ZR_W(2) * dx + ZR_W(5) * dy + ZR_W(8) * dz;
  const bool par = fabsf(dw) < 1e-12f;
  const float ow = ZR_W(2) * ox + ZR_W(5) * oy + ZR_W(8) * oz + ZR_W(11);
  const float t = -ow / (par ? 1.0f : dw);
  if (par || !(t > t_min) || !(t < t_max)) return ZR_INF;
  const float ou = ZR_W(0) * ox + ZR_W(3) * oy + ZR_W(6) * oz + ZR_W(9);
  const float du = ZR_W(0) * dx + ZR_W(3) * dy + ZR_W(6) * dz;
  const float u = ou + t * du;
  if (!(u >= 0.0f)) return ZR_INF;
  const float ov = ZR_W(1) * ox + ZR_W(4) * oy + ZR_W(7) * oz + ZR_W(10);
  const float dv = ZR_W(1) * dx + ZR_W(4) * dy + ZR_W(7) * dz;
  const float v = ov + t * dv;
#undef ZR_W
  if (!(v >= 0.0f) || !(u + v <= 1.0f)) return ZR_INF;
  *u_out = u;
  *v_out = v;
  return t;
}

// The Woop test of triangle j of a chunk in shared memory.
__device__ __forceinline__ float woop_hit(const WoopChunk& s, int j, float ox, float oy,
                                          float oz, float dx, float dy, float dz,
                                          float t_min, float t_max, float* u_out,
                                          float* v_out) {
  return woop_test(&s.w[0][0], kTriChunk, j, ox, oy, oz, dx, dy, dz, t_min, t_max, u_out,
                   v_out);
}

// Closest hit of the ray (o, d) over triangles [0, tp) of woop [4, 3, tp],
// with t in (t_min, t_max). Returns t (ZR_INF on a miss), the triangle in
// *tri (-1 on a miss) and its barycentrics (0 on a miss). The tie rule is
// the JAX kernels': within a group of `tie` consecutive triangles (a
// multiple of kTriChunk that divides tp) the highest index among equal t
// wins; a later group replaces the winner only with a strictly smaller t.
// Every thread of the block must call it (the triangles stream through
// `chunk`); threads with live == false only help load.
__device__ __forceinline__ float closest_hit(WoopChunk& chunk, const float* __restrict__ woop,
                                             int tp, int tie, float ox, float oy, float oz,
                                             float dx, float dy, float dz, float t_min,
                                             float t_max, bool live, int* tri, float* bu,
                                             float* bv) {
  float best_t = ZR_INF;
  *tri = -1;
  *bu = 0.f;
  *bv = 0.f;
  for (int g0 = 0; g0 < tp; g0 += tie) {  // one tie group
    float ct = ZR_INF, cu = 0.f, cv = 0.f;
    int cj = -1;
    for (int c0 = g0; c0 < g0 + tie; c0 += kTriChunk) {
      __syncthreads();
      load_woop_chunk(chunk, woop, tp, c0);
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < kTriChunk; ++j) {
        float u, v;
        const float t = woop_hit(chunk, j, ox, oy, oz, dx, dy, dz, t_min, t_max, &u, &v);
        if (t < ZR_INF && t <= ct) {
          ct = t; cu = u; cv = v; cj = c0 + j;
        }
      }
    }
    if (ct < best_t) {
      best_t = ct; *bu = cu; *bv = cv; *tri = cj;
    }
  }
  return best_t;
}

}  // namespace zr
