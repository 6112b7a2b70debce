// Primary-hit G-buffer (kernel B1, zetaray_tpu_torch.accel.megakernel.gbuffer):
// the closest hit of each camera ray over the scene's real triangles, then
// the winner's attributes written as the 40 rows of G (megakernel.G). It
// replaces the TPU kernel _gbuffer_kernel of the JAX package's
// accel/megakernel.py.
//
// What bounds it on the card: the Woop arithmetic of the sweep, every ray
// against every real triangle (about 40 float operations and one division a
// pair, at most half the card's float32 rate without FMAs), not bytes: a
// ray reads 24 bytes and one attribute row and writes 160.
//
// What the design does about it: one call of sweep.cuh's closest_sweep
// (the real triangles only, triangle-major rows as 16-byte broadcasts from
// a double-buffered ring, the sign test before the division, candidates
// beyond the best t dropped before their edge tests), one ray a thread,
// BOUNCE_BLOCK threads a block. Unlike the other sweep kernels it takes no
// 64-register cap: during the sweep a thread holds only its ray and the
// running best, and the epilogue reads the winner's attribute row by index
// as it needs each column, so it builds to 56 registers without a spill and
// fits 9 blocks an SM (the cap's 8 blocks build to 64 registers and measured
// slower at 8192 triangles, PERF.md section 6).
//
// The tie rule is the JAX kernel's: within a group of 128 slots (kTriChunk)
// the highest index among equal t wins, a later group only with a strictly
// smaller t.
#include "sweep.cuh"
#include "layout.h"  // A_* (scene.A) and G_* (accel.megakernel.G)

namespace {

__global__ void __launch_bounds__(BOUNCE_BLOCK)
gbuffer_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float4* __restrict__ tri_rows, const float* __restrict__ attrs,
               float* __restrict__ out, int n, int nt, float t_min) {
  __shared__ zr::SweepRing ring;
  const int i = blockIdx.x * BOUNCE_BLOCK + threadIdx.x;
  // past n the all-zero ray, which misses every triangle
  const zr::Ray ray = i < n ? zr::Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2],
                                      d[3 * i], d[3 * i + 1], d[3 * i + 2]}
                            : zr::Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const zr::Hit h = zr::closest_sweep(ring, tri_rows, nt, zr::kTriChunk, ray, t_min, ZR_INF);
  if (i >= n) return;

  const float ox = ray.ox, oy = ray.oy, oz = ray.oz, dx = ray.dx, dy = ray.dy, dz = ray.dz;
  const int best = h.tri;
  const float best_t = h.t, bu = h.u, bv = h.v;
  const bool hit = best >= 0;
  const float* row = attrs + (size_t)(hit ? best : 0) * A_WIDTH;
  auto at = [&](int k) { return hit ? row[k] : 0.f; };

  const float wo_dot_ng = -(dx * at(A_NG) + dy * at(A_NG + 1) + dz * at(A_NG + 2));
  const bool front = wo_dot_ng > 0.f;
  const float sgn = front ? 1.f : -1.f;
  const float ngx = at(A_NG) * sgn, ngy = at(A_NG + 1) * sgn, ngz = at(A_NG + 2) * sgn;
  const float w0 = 1.f - bu - bv;
  float nsx = at(A_N0) * w0 + at(A_N1) * bu + at(A_N2) * bv;
  float nsy = at(A_N0 + 1) * w0 + at(A_N1 + 1) * bu + at(A_N2 + 1) * bv;
  float nsz = at(A_N0 + 2) * w0 + at(A_N1 + 2) * bu + at(A_N2 + 2) * bv;
  const float inv = rsqrtf(fmaxf(nsx * nsx + nsy * nsy + nsz * nsz, 1e-20f));
  nsx = nsx * inv * sgn;
  nsy = nsy * inv * sgn;
  nsz = nsz * inv * sgn;
  if (nsx * ngx + nsy * ngy + nsz * ngz < 0.f) {
    nsx = -nsx; nsy = -nsy; nsz = -nsz;
  }
  const bool vis_side = (at(A_DOUBLE) > 0.5f) || front;
  const float le_gain = (hit && vis_side) ? 1.f : 0.f;
  const float ior = fmaxf(at(A_IOR), 1.01f);

  float g[G_ROWS];
  g[G_POS] = ox + dx * best_t;
  g[G_POS + 1] = oy + dy * best_t;
  g[G_POS + 2] = oz + dz * best_t;
  g[G_NS] = nsx; g[G_NS + 1] = nsy; g[G_NS + 2] = nsz;
  g[G_NG] = ngx; g[G_NG + 1] = ngy; g[G_NG + 2] = ngz;
  g[G_BASE] = at(A_BASE); g[G_BASE + 1] = at(A_BASE + 1); g[G_BASE + 2] = at(A_BASE + 2);
  g[G_METAL] = at(A_METAL);
  g[G_ROUGH] = at(A_ROUGH);
  g[G_IOR] = ior;
  g[G_VALID] = hit ? 1.f : 0.f;
  g[G_DEPTH] = hit ? best_t : 0.f;
  g[G_WO] = -dx; g[G_WO + 1] = -dy; g[G_WO + 2] = -dz;
  g[G_EMISS] = at(A_EMISS) * le_gain;
  g[G_EMISS + 1] = at(A_EMISS + 1) * le_gain;
  g[G_EMISS + 2] = at(A_EMISS + 2) * le_gain;
  g[G_EM_PDF_AREA] = at(A_EM_PDF_AREA);
  g[G_UV] = w0 * at(A_UV0) + bu * at(A_UV1) + bv * at(A_UV2);
  g[G_UV + 1] = w0 * at(A_UV0 + 1) + bu * at(A_UV1 + 1) + bv * at(A_UV2 + 1);
  g[G_TEXID] = hit ? at(A_TEXID) : -1.f;
  g[G_TRANS] = at(A_TRANS);
  g[G_ETA] = front ? 1.f / ior : ior;
  g[G_COATW] = at(A_COATW);
  g[G_COATR] = at(A_COATR);
  g[G_MATID] = hit ? at(A_MATID) : -1.f;
  g[G_TANG] = at(A_TANG); g[G_TANG + 1] = at(A_TANG + 1); g[G_TANG + 2] = at(A_TANG + 2);
  g[G_UVDENS] = at(A_UVDENS);
  g[G_INST] = hit ? at(A_INSTID) : -1.f;
  for (int r = G_INST + 1; r < G_ROWS; ++r) g[r] = 0.f;
  // [40, n] output: thread i writes column i of every row (coalesced).
#pragma unroll
  for (int r = 0; r < G_ROWS; ++r) out[(size_t)r * n + i] = g[r];
}

}  // namespace

// tri_rows: the triangle-major Woop rows [tp][12] (SceneBuffers.woop_rows());
// nt: the real triangles, the first nt slots; t_min >= 0 (the sign test).
extern "C" int zr_gbuffer(const float* o, const float* d, const float* tri_rows,
                          const float* attrs, float* out, int n, int tp, int nt, float t_min,
                          void* stream) {
  if (nt < 0 || nt > tp || !(t_min >= 0.f)) return (int)cudaErrorInvalidValue;
  const int grid = (n + BOUNCE_BLOCK - 1) / BOUNCE_BLOCK;
  if (grid > 0) {
    gbuffer_kernel<<<grid, BOUNCE_BLOCK, 0, (cudaStream_t)stream>>>(
        o, d, reinterpret_cast<const float4*>(tri_rows), attrs, out, n, nt, t_min);
  }
  return (int)cudaGetLastError();
}
