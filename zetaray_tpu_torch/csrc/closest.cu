// Closest hit plus the winner's attribute row (kernel B7): for each ray the
// closest (t, tri, u, v) over every triangle in (t_min, t_max), and row tri
// of the attribute table written as column i of the [A_WIDTH, n] output.
//
// Replaces _closest_kernel of the JAX package (accel/pallas_kernels.py).
// Bound by the Woop arithmetic, about 40 float operations per ray-triangle
// pair, against 232 bytes per ray. The triangles stream through the sweep
// of sweep.cuh (real triangles only, triangle-major rows read as 16-byte
// broadcasts, one ray a thread, double-buffered cp.async chunks),
// with the JAX kernel's tie rule over its triangle tile `tie`
// (accel.intersect.tie_chunk): the highest index among equal t within a
// tile, a later tile only with a strictly smaller t. The TPU fetched the
// winner's row with a one-hot matmul per tile; here the thread reads it by
// index after the sweep.
#include "sweep.cuh"
#include "layout.h"  // A_WIDTH

namespace {

__global__ void __launch_bounds__(BOUNCE_BLOCK, zr::kSweepBlocks)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float4* __restrict__ tri_rows, const float* __restrict__ attrs,
               float* __restrict__ t_out, int32_t* __restrict__ tri_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               float* __restrict__ attr_out, int n, int nt, int tie, float t_min, float t_max) {
  __shared__ zr::SweepRing ring;
  const int i = blockIdx.x * BOUNCE_BLOCK + threadIdx.x;
  const zr::Ray ray = i < n ? zr::Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                                      d[3 * i + 1], d[3 * i + 2]}
                            : zr::Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const zr::Hit hit = zr::closest_sweep(ring, tri_rows, nt, tie, ray, t_min, t_max);
  if (i >= n) return;
  t_out[i] = hit.t;
  tri_out[i] = hit.tri;
  u_out[i] = hit.u;
  v_out[i] = hit.v;
  const float* row = attrs + (size_t)(hit.tri >= 0 ? hit.tri : 0) * A_WIDTH;
  // [A_WIDTH, n] output: thread i writes column i of every row (coalesced).
  for (int k = 0; k < A_WIDTH; ++k) attr_out[(size_t)k * n + i] = hit.tri >= 0 ? row[k] : 0.f;
}

}  // namespace

// tri_rows: the triangle-major Woop rows [tp][12] (SceneBuffers.woop_rows());
// nt: the real triangles, the first nt slots.
extern "C" int zr_closest(const float* o, const float* d, const float* tri_rows,
                          const float* attrs, float* t, int32_t* tri, float* u, float* v,
                          float* attr_out, int n, int tp, int nt, int tie, float t_min,
                          float t_max, void* stream) {
  if (tie <= 0 || tp % tie || nt < 0 || nt > tp || !(t_min >= 0.f)) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = (n + BOUNCE_BLOCK - 1) / BOUNCE_BLOCK;
  if (grid > 0) {
    closest_kernel<<<grid, BOUNCE_BLOCK, 0, (cudaStream_t)stream>>>(
        o, d, reinterpret_cast<const float4*>(tri_rows), attrs, t, tri, u, v, attr_out, n, nt,
        tie, t_min, t_max);
  }
  return (int)cudaGetLastError();
}
