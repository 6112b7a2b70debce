// Any-hit occlusion (kernel B3): does any triangle cut the ray or segment
// within (t_min, t_max)?
//
// Replaces _occlusion_kernel of the JAX package (accel/pallas_kernels.py).
// Bound by the Woop arithmetic: about 40 float operations per ray-triangle
// pair for a segment that lets its light through, one test for a blocked
// one. One call of the dense sweep's any-hit loop (sweep.cuh
// occluded_sweep, also B6's shadow segment): the num_tris real triangles
// only, triangle-major rows read as three 16-byte broadcasts, chunks
// double-buffered by cp.async, a pair dropped by the signs of its plane
// distances before the division (exact for t_min >= 0, which the entry
// point checks). A ray stops testing at its first hit, a warp whose rays
// are all blocked skips the chunk, and the block leaves once all its rays
// are.
#include "sweep.cuh"

namespace {

__global__ void __launch_bounds__(BOUNCE_BLOCK, zr::kSweepBlocks)
occlusion_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float4* __restrict__ tri_rows, int32_t* __restrict__ out, int n, int nt,
                 float t_min, float t_max) {
  __shared__ zr::SweepRing ring;
  const int i = blockIdx.x * BOUNCE_BLOCK + threadIdx.x;
  const bool live = i < n;
  const zr::Ray ray = live ? zr::Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                                     d[3 * i + 1], d[3 * i + 2]}
                           : zr::Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // padding lanes count as done
  const bool occ = zr::occluded_sweep(ring, tri_rows, nt, ray, t_min, t_max, !live);
  if (live) out[i] = occ ? 1 : 0;
}

}  // namespace

// tri_rows: the triangle-major Woop rows [tp][12] (SceneBuffers.woop_rows());
// nt: the real triangles, the first nt slots.
extern "C" int zr_occlusion(const float* o, const float* d, const float* tri_rows,
                            int32_t* out, int n, int tp, int nt, float t_min, float t_max,
                            void* stream) {
  if (nt < 0 || nt > tp || !(t_min >= 0.f)) return (int)cudaErrorInvalidValue;
  const int grid = (n + BOUNCE_BLOCK - 1) / BOUNCE_BLOCK;
  if (grid > 0) {
    occlusion_kernel<<<grid, BOUNCE_BLOCK, 0, (cudaStream_t)stream>>>(
        o, d, reinterpret_cast<const float4*>(tri_rows), out, n, nt, t_min, t_max);
  }
  return (int)cudaGetLastError();
}
