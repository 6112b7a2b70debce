// Any-hit occlusion: does any triangle cut the ray or segment within
// (t_min, t_max)?
//
// One thread per ray, triangles streamed through shared memory in chunks of
// 128 as in gbuffer.cu. A ray stops testing at its first hit, and the whole
// block leaves the triangle loop once every ray in it is occluded.
#include "common.cuh"

namespace {

__global__ void occlusion_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                 const float* __restrict__ woop, int32_t* __restrict__ out,
                                 int n, int tp, float t_min, float t_max) {
  __shared__ zr::WoopChunk chunk;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float ox = live ? o[3 * i] : 0.f, oy = live ? o[3 * i + 1] : 0.f,
              oz = live ? o[3 * i + 2] : 0.f;
  const float dx = live ? d[3 * i] : 0.f, dy = live ? d[3 * i + 1] : 0.f,
              dz = live ? d[3 * i + 2] : 0.f;
  bool occluded = !live;  // padding lanes count as done
  for (int c0 = 0; c0 < tp; c0 += zr::kTriChunk) {
    if (__syncthreads_and(occluded)) break;
    zr::load_woop_chunk(chunk, woop, tp, c0);
    __syncthreads();
    for (int j = 0; j < zr::kTriChunk && !occluded; ++j) {
      float u, v;
      occluded = zr::woop_hit(chunk, j, ox, oy, oz, dx, dy, dz, t_min, t_max, &u, &v) < ZR_INF;
    }
  }
  if (live) out[i] = occluded ? 1 : 0;
}

}  // namespace

extern "C" int zr_occlusion(const float* o, const float* d, const float* woop, int32_t* out,
                            int n, int tp, float t_min, float t_max, void* stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (grid > 0) {
    occlusion_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(o, d, woop, out, n, tp, t_min,
                                                                t_max);
  }
  return (int)cudaGetLastError();
}
