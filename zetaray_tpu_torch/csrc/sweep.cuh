// The dense ray-triangle sweep of every kernel that queries a dense scene:
// B1 (gbuffer.cu: its closest hit), B3 (occlusion.cu), B4 (bounce.cu
// bounce_trace_kernel: its closest hit), B5 (bounce.cu bounce_shade_kernel:
// its NEE shadow segment), B6 (bounce.cu bounce_kernel: its closest hit and
// its NEE shadow segment) and B7 (closest.cu).
//
// What bounds it: every ray tests every real triangle, about 40 float
// operations and one IEEE division a pair, against a few hundred bytes a
// ray. The kernels build with --fmad=false so that each operation rounds as
// in the plain versions; without FMAs the card issues at most half of the
// 67 TFLOP/s that counts an FMA as two operations. Rays that scatter
// (bounce and prefix rays) take different branches of the test in one warp,
// so a warp pays for the longest path of its lanes.
//
// What the design does about it:
// - It sweeps slots [0, nt) only: the upload pads the table to a multiple of
//   128 with all-zero Woop rows, which never hit (|dw| < 1e-12), so they can
//   neither win nor occlude.
// - It stages triangle-major rows (SceneBuffers.woop_rows(): per triangle
//   the w, u and v rows of the Woop transform, x, y, z, translation each), so a
//   pair reads its 12 coefficients with three 16-byte shared-memory
//   broadcasts instead of twelve 4-byte ones.
// - The chunks arrive through a two-stage ring filled by 16-byte cp.async
//   copies: chunk k+1 is in flight while chunk k is tested, with one block
//   barrier a chunk.
// - With t_min >= 0 (the wrappers check it) a pair whose ow and dw have the
//   same sign, or ow == 0, is dropped before the division: the sign of an
//   IEEE quotient is exact, so t = -ow / dw could not pass t > t_min.
// - A closest-hit candidate is dropped before its edge tests when its t
//   cannot win: beyond the best of the earlier tie groups, or beyond the best
//   of its own group (equal t still goes on, the highest index wins).
// - One ray a thread, BOUNCE_BLOCK threads a block. On the H100 two or four
//   rays a thread measured slower: each ray's test is a chain of branches,
//   so a thread's rays do not overlap, and their state halves the warps an
//   SM holds.
// - The kernels that sweep cap themselves at 64 registers (kSweepBlocks
//   blocks of 128 threads an SM): uncapped, B7 takes 168 registers, B6 85
//   and B5 79, and all three measured slower so. B1 takes no cap: it builds
//   to 56 registers without one.
// Each ray visits the triangles in ascending order, and the pruning drops
// only pairs that could not change the answer, so the outputs equal the
// plain versions' (accel.megakernel.closest_hit_plain,
// accel.intersect.occlusion_plain) bit for bit.
//
// The tie group `tie` (B1, B4, B6: kTriChunk, the JAX kernels' chunk; B7: the
// Pallas tile, accel.intersect.tie_chunk) is counted from slot 0 and is
// independent of the staging width kSweepChunk.
//
// A sweep may follow another on the same ring (B6 sweeps twice): each starts
// with a block barrier, so no warp still reads a stage of the earlier sweep
// when the first chunk is copied over it.
//
// Built on the host (a g++ rehearsal against a mock CUDA header, where
// __CUDA_ARCH__ is undefined) the async copies are plain copies.
#pragma once

#include "common.cuh"

namespace zr {

constexpr int kSweepChunk = 128;  // triangles a ring stage
constexpr int kSweepBlocks = 8;   // __launch_bounds__ blocks of BOUNCE_BLOCK threads an SM

// Two stages of kSweepChunk triangles, three float4 rows each (w, u, v).
struct SweepRing {
  float4 tri[2][3 * kSweepChunk];
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// A closest hit: t (ZR_INF on a miss), triangle (-1 on a miss), barycentrics.
struct Hit {
  float t, u, v;
  int tri;
};

__device__ __forceinline__ void copy16_async(float4* dst, const float4* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits for this thread's copies; a block barrier then publishes them.
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Starts copying triangles [c0, min(c0 + kSweepChunk, nt)) of tri [tp][3]
// into ring stage s. Every thread of the block must call it.
__device__ __forceinline__ void stage_chunk(SweepRing& ring, int s,
                                            const float4* __restrict__ tri, int nt, int c0) {
  const int cnt = 3 * min(kSweepChunk, nt - c0);
  const float4* src = tri + (size_t)3 * c0;
  for (int k = threadIdx.x; k < cnt; k += blockDim.x) copy16_async(&ring.tri[s][k], src + k);
  copy_commit();
}

// The Woop test of one staged triangle (rows w, u, v) against a ray, in the
// operation order of the plain version (accel.megakernel.tri_hits), for
// t_min >= 0. Returns t, or
// ZR_INF unless the ray hits with t_min < t < t_lt and t <= t_le.
__device__ __forceinline__ float sweep_test(const float4& w, const float4& a, const float4& b,
                                            const Ray& r, float t_min, float t_lt, float t_le,
                                            float* u_out, float* v_out) {
  const float dw = w.x * r.dx + w.y * r.dy + w.z * r.dz;
  const float ow = w.x * r.ox + w.y * r.oy + w.z * r.oz + w.w;
  if (fabsf(dw) < 1e-12f || ow == 0.f || (ow < 0.f) == (dw < 0.f)) return ZR_INF;
  const float t = -ow / dw;
  if (!(t > t_min) || !(t < t_lt) || !(t <= t_le)) return ZR_INF;
  const float ou = a.x * r.ox + a.y * r.oy + a.z * r.oz + a.w;
  const float du = a.x * r.dx + a.y * r.dy + a.z * r.dz;
  const float u = ou + t * du;
  if (!(u >= 0.0f)) return ZR_INF;
  const float ov = b.x * r.ox + b.y * r.oy + b.z * r.oz + b.w;
  const float dv = b.x * r.dx + b.y * r.dy + b.z * r.dz;
  const float v = ov + t * dv;
  if (!(v >= 0.0f) || !(u + v <= 1.0f)) return ZR_INF;
  *u_out = u;
  *v_out = v;
  return t;
}

// Closest hit of a ray over triangles [0, nt) of tri [tp][3] with t in
// (t_min, t_max), with the JAX kernels' tie rule over groups of `tie`
// slots: within a group the highest index among equal t wins, a later group
// replaces the winner only with a strictly smaller t. A ray of all zeros
// misses every triangle at once (a thread past the end). Every thread of the
// block must call it.
__device__ __forceinline__ Hit closest_sweep(SweepRing& ring, const float4* __restrict__ tri,
                                             int nt, int tie, const Ray& ray, float t_min,
                                             float t_max) {
  Hit best = {ZR_INF, 0.f, 0.f, -1};
  Hit cur = best;     // the best of the open tie group
  float lim = t_max;  // t must stay below: t_max, then the best of the closed groups
  const int n_chunks = (nt + kSweepChunk - 1) / kSweepChunk;
  __syncthreads();  // the ring is free
  if (n_chunks > 0) stage_chunk(ring, 0, tri, nt, 0);
  int g_end = tie;  // end of the open tie group
  for (int k = 0; k < n_chunks; ++k) {
    copy_wait();
    __syncthreads();  // chunk k has arrived; every thread is done with chunk k - 1
    if (k + 1 < n_chunks) stage_chunk(ring, (k + 1) & 1, tri, nt, (k + 1) * kSweepChunk);
    const float4* s = ring.tri[k & 1];
    const int c0 = k * kSweepChunk, c1 = min(c0 + kSweepChunk, nt);
    for (int j0 = c0; j0 < c1;) {
      const int j1 = min(c1, g_end);
      for (int j = j0; j < j1; ++j) {
        const float4 w = s[3 * (j - c0)], a = s[3 * (j - c0) + 1], b = s[3 * (j - c0) + 2];
        float u, v;
        const float t = sweep_test(w, a, b, ray, t_min, lim, cur.t, &u, &v);
        if (t < ZR_INF) cur = {t, u, v, j};
      }
      j0 = j1;
      if (j1 == g_end) {  // the group ends: its winner replaces the best only if nearer
        if (cur.t < best.t) {
          best = cur;
          lim = cur.t;
        }
        cur = {ZR_INF, 0.f, 0.f, -1};
        g_end += tie;
      }
    }
  }
  return cur.t < best.t ? cur : best;
}

// Any hit of a segment over triangles [0, nt) with t in (t_min, t_max),
// unless it is `done` already. A warp whose segments are all done stops
// testing, and the block leaves once all its warps are done. Every thread of
// the block must call it.
__device__ __forceinline__ bool occluded_sweep(SweepRing& ring, const float4* __restrict__ tri,
                                               int nt, const Ray& seg, float t_min, float t_max,
                                               bool done) {
  bool occ = false;
  const int n_chunks = (nt + kSweepChunk - 1) / kSweepChunk;
  __syncthreads();  // the ring is free
  if (n_chunks > 0) stage_chunk(ring, 0, tri, nt, 0);
  for (int k = 0; k < n_chunks; ++k) {
    copy_wait();
    if (__syncthreads_and(done)) break;  // no copy is in flight here
    if (k + 1 < n_chunks) stage_chunk(ring, (k + 1) & 1, tri, nt, (k + 1) * kSweepChunk);
    if (__all_sync(0xffffffffu, done)) continue;
    const float4* s = ring.tri[k & 1];
    const int c0 = k * kSweepChunk, c1 = min(c0 + kSweepChunk, nt);
    for (int j = c0; j < c1 && !done; ++j) {
      const float4 w = s[3 * (j - c0)], a = s[3 * (j - c0) + 1], b = s[3 * (j - c0) + 2];
      float u, v;
      done = occ = sweep_test(w, a, b, seg, t_min, t_max, ZR_INF, &u, &v) < ZR_INF;
    }
  }
  return occ;
}

}  // namespace zr
