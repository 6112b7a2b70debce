// Closest hit plus the winner's attribute row (kernel B7): for each ray the
// closest (t, tri, u, v) over every triangle in (t_min, t_max), and row tri
// of the attribute table written as column i of the [A_WIDTH, n] output.
//
// Replaces _closest_kernel of the JAX package (accel/pallas_kernels.py).
// Bound by the Woop arithmetic, about 40 float operations per ray-triangle
// pair, against 232 bytes per ray. One thread per ray; the triangles stream
// through shared memory as in gbuffer.cu (zr::closest_hit), with the JAX
// kernel's tie rule over its triangle tile `tie` (accel.intersect.tie_chunk):
// the highest index among equal t within a tile, a later tile only with a
// strictly smaller t. The TPU fetched the winner's row with a one-hot
// matmul per tile; here the thread reads it by index after the loop.
#include "common.cuh"
#include "layout.h"  // A_WIDTH

namespace {

__global__ void closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                               const float* __restrict__ woop,
                               const float* __restrict__ attrs, float* __restrict__ t_out,
                               int32_t* __restrict__ tri_out, float* __restrict__ u_out,
                               float* __restrict__ v_out, float* __restrict__ attr_out, int n,
                               int tp, int tie, float t_min, float t_max) {
  __shared__ zr::WoopChunk chunk;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float ox = live ? o[3 * i] : 0.f, oy = live ? o[3 * i + 1] : 0.f,
              oz = live ? o[3 * i + 2] : 0.f;
  const float dx = live ? d[3 * i] : 0.f, dy = live ? d[3 * i + 1] : 0.f,
              dz = live ? d[3 * i + 2] : 0.f;
  int tri;
  float bu, bv;
  const float t = zr::closest_hit(chunk, woop, tp, tie, ox, oy, oz, dx, dy, dz, t_min, t_max,
                                  live, &tri, &bu, &bv);
  if (!live) return;
  t_out[i] = t;
  tri_out[i] = tri;
  u_out[i] = bu;
  v_out[i] = bv;
  const float* row = attrs + (size_t)(tri >= 0 ? tri : 0) * A_WIDTH;
  // [A_WIDTH, n] output: thread i writes column i of every row (coalesced).
  for (int k = 0; k < A_WIDTH; ++k) attr_out[(size_t)k * n + i] = tri >= 0 ? row[k] : 0.f;
}

}  // namespace

extern "C" int zr_closest(const float* o, const float* d, const float* woop, const float* attrs,
                          float* t, int32_t* tri, float* u, float* v, float* attr_out, int n,
                          int tp, int tie, float t_min, float t_max, void* stream) {
  if (tie <= 0 || tie % zr::kTriChunk || tp % tie) return (int)cudaErrorInvalidValue;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (grid > 0) {
    closest_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(o, d, woop, attrs, t, tri, u, v,
                                                              attr_out, n, tp, tie, t_min, t_max);
  }
  return (int)cudaGetLastError();
}
