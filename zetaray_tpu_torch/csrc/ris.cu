// ReSTIR DI initial candidates: full-set RIS over a presampled light set.
//
// One thread per pixel. Pixel p uses light set (31 * (p / rt)) % n_sets,
// where rt is the JAX frame's tile width: that mapping is part of what the
// frame computes, so it is kept. The block size divides rt, so a block's
// pixels share one set, which is staged in shared memory once (its first
// LSET_STAGED rows, plus each entry's luminance). Each thread rates all ps entries with
// the albedo/pi target, takes a sequential inclusive sum, draws one pcg4d
// uniform (salt 0x51E5, the stream of core.rng.uniform4) and picks the first
// entry whose running sum exceeds u * w_sum in a second pass over the same
// weights.
#include "common.cuh"
#include "layout.h"  // G_*, LSET_ROWS, LSET_STAGED, R_ROWS

namespace {

// Light-set rows: 0-2 pos | 3-5 ng | 6-8 Le | 9 pdf | 10 two-sided.
constexpr int kLum = LSET_STAGED;  // staged row of the luminance of Le
constexpr int kStaged = LSET_STAGED + 1;

struct Surface {
  float px, py, pz, nx, ny, nz, base_l;
  bool valid;
};

// RIS weight of set entry k at this surface; *phat_out gets its target.
__device__ __forceinline__ float ris_weight(const float* __restrict__ s, int ps, int k,
                                            const Surface& sf, float* phat_out) {
  const float tx = s[0 * ps + k] - sf.px;
  const float ty = s[1 * ps + k] - sf.py;
  const float tz = s[2 * ps + k] - sf.pz;
  const float dist2 = fmaxf(tx * tx + ty * ty + tz * tz, 1e-12f);
  const float inv_d = rsqrtf(dist2);
  const float cos_surf = (tx * sf.nx + ty * sf.ny + tz * sf.nz) * inv_d;
  const float cos_l_raw = -(tx * s[3 * ps + k] + ty * s[4 * ps + k] + tz * s[5 * ps + k]) * inv_d;
  const float cos_l = s[10 * ps + k] > 0.5f ? fabsf(cos_l_raw) : cos_l_raw;
  float phat = sf.base_l * s[kLum * ps + k] * cos_surf * cos_l / dist2;
  phat = (cos_surf > 1e-6f && cos_l > 1e-6f) ? fmaxf(phat, 0.f) : 0.f;
  *phat_out = phat;
  const float pdf = s[9 * ps + k];
  return (sf.valid && pdf > 0.f) ? phat / fmaxf(pdf, 1e-12f) : 0.f;
}

__global__ void ris_kernel(const float* __restrict__ gb, const float* __restrict__ sets,
                           float* __restrict__ out, int n, int n_sets, int ps, int rt,
                           uint32_t seed) {
  extern __shared__ float s[];  // [kStaged][ps]
  const int p0 = blockIdx.x * blockDim.x;
  const int set = (int)(((long long)(p0 / rt) * 31) % n_sets);
  zr::stage_light_set(s, sets, set, ps);
  const float* src = sets + (size_t)set * LSET_ROWS * ps;
  for (int k = threadIdx.x; k < ps; k += blockDim.x) {
    s[kLum * ps + k] = 0.2126f * src[6 * ps + k] + 0.7152f * src[7 * ps + k] +
                       0.0722f * src[8 * ps + k];
  }
  __syncthreads();
  const int i = p0 + threadIdx.x;
  if (i >= n) return;

  Surface sf;
  sf.px = gb[(size_t)(G_POS + 0) * n + i];
  sf.py = gb[(size_t)(G_POS + 1) * n + i];
  sf.pz = gb[(size_t)(G_POS + 2) * n + i];
  sf.nx = gb[(size_t)(G_NS + 0) * n + i];
  sf.ny = gb[(size_t)(G_NS + 1) * n + i];
  sf.nz = gb[(size_t)(G_NS + 2) * n + i];
  const float bx = gb[(size_t)(G_BASE + 0) * n + i];
  const float by = gb[(size_t)(G_BASE + 1) * n + i];
  const float bz = gb[(size_t)(G_BASE + 2) * n + i];
  sf.base_l = (0.2126f * (bx + 0.04f) + 0.7152f * (by + 0.04f) + 0.0722f * (bz + 0.04f)) *
              0.3183098861f;
  sf.valid = gb[(size_t)G_VALID * n + i] > 0.5f;

  float w_sum = 0.f, phat;
  for (int k = 0; k < ps; ++k) w_sum = w_sum + ris_weight(s, ps, k, sf, &phat);

  uint32_t h0 = (uint32_t)i, h1 = 0u, h2 = seed, h3 = 0x51E5u;
  zr::pcg4d(h0, h1, h2, h3);
  const float u = zr::to_unit(h0);
  const float target = u * w_sum;
  int idx = ps - 1;
  float cum = 0.f, y_phat = 0.f;
  for (int k = 0; k < ps; ++k) {
    cum = cum + ris_weight(s, ps, k, sf, &phat);
    if (cum > target) {
      idx = k;
      y_phat = phat;
      break;
    }
  }
  if (idx == ps - 1) ris_weight(s, ps, idx, sf, &y_phat);

  const float m_count = (float)ps;
  const float big_w = y_phat > 0.f ? w_sum / fmaxf(m_count * y_phat, 1e-12f) : 0.f;
  float r[R_ROWS];
  for (int k = 0; k < 9; ++k) r[k] = s[k * ps + idx];
  r[9] = w_sum;
  r[10] = m_count;
  r[11] = big_w;
  r[12] = s[10 * ps + idx];
  r[13] = y_phat;
  for (int k = 14; k < R_ROWS; ++k) r[k] = 0.f;
#pragma unroll
  for (int k = 0; k < R_ROWS; ++k) out[(size_t)k * n + i] = r[k];
}

}  // namespace

extern "C" int zr_ris(const float* gb, const float* sets, float* out, int n, int n_sets, int ps,
                      int rt, int block, uint32_t seed, void* stream) {
  const int grid = (n + block - 1) / block;
  const size_t smem = (size_t)kStaged * ps * sizeof(float);
  if (grid > 0) {
    ris_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(gb, sets, out, n, n_sets, ps, rt,
                                                             seed);
  }
  return (int)cudaGetLastError();
}
