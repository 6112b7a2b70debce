// Primary-hit G-buffer: closest hit of each camera ray over every triangle,
// then the winner's attributes written as the 40 rows of G
// (zetaray_tpu_torch.accel.megakernel.G).
//
// One thread per ray. The block's triangles stream through shared memory in
// chunks of 128 Woop columns (6 KB), read by every thread of the block at
// the same address (a broadcast, no bank conflicts). The tie rule is the
// JAX kernel's: within a chunk of 128 the highest index among equal t wins,
// across chunks only a strictly smaller t replaces the winner
// (zr::closest_hit with tie = kTriChunk).
#include "common.cuh"
#include "layout.h"  // A_* (scene.A) and G_* (accel.megakernel.G)

namespace {

__global__ void gbuffer_kernel(const float* __restrict__ o, const float* __restrict__ d,
                               const float* __restrict__ woop,
                               const float* __restrict__ attrs, float* __restrict__ out,
                               int n, int tp, float t_min) {
  __shared__ zr::WoopChunk chunk;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float ox = live ? o[3 * i] : 0.f, oy = live ? o[3 * i + 1] : 0.f,
              oz = live ? o[3 * i + 2] : 0.f;
  const float dx = live ? d[3 * i] : 0.f, dy = live ? d[3 * i + 1] : 0.f,
              dz = live ? d[3 * i + 2] : 0.f;

  int best;
  float bu, bv;
  const float best_t = zr::closest_hit(chunk, woop, tp, zr::kTriChunk, ox, oy, oz, dx, dy, dz,
                                       t_min, ZR_INF, live, &best, &bu, &bv);
  if (!live) return;

  const bool hit = best >= 0;
  float at[A_WIDTH];
#pragma unroll
  for (int k = 0; k < A_WIDTH; ++k) at[k] = hit ? attrs[(size_t)best * A_WIDTH + k] : 0.f;

  const float wo_dot_ng = -(dx * at[A_NG] + dy * at[A_NG + 1] + dz * at[A_NG + 2]);
  const bool front = wo_dot_ng > 0.f;
  const float sgn = front ? 1.f : -1.f;
  const float ngx = at[A_NG] * sgn, ngy = at[A_NG + 1] * sgn, ngz = at[A_NG + 2] * sgn;
  const float w0 = 1.f - bu - bv;
  float nsx = at[A_N0] * w0 + at[A_N1] * bu + at[A_N2] * bv;
  float nsy = at[A_N0 + 1] * w0 + at[A_N1 + 1] * bu + at[A_N2 + 1] * bv;
  float nsz = at[A_N0 + 2] * w0 + at[A_N1 + 2] * bu + at[A_N2 + 2] * bv;
  const float inv = rsqrtf(fmaxf(nsx * nsx + nsy * nsy + nsz * nsz, 1e-20f));
  nsx = nsx * inv * sgn;
  nsy = nsy * inv * sgn;
  nsz = nsz * inv * sgn;
  if (nsx * ngx + nsy * ngy + nsz * ngz < 0.f) {
    nsx = -nsx; nsy = -nsy; nsz = -nsz;
  }
  const bool vis_side = (at[A_DOUBLE] > 0.5f) || front;
  const float le_gain = (hit && vis_side) ? 1.f : 0.f;
  const float ior = fmaxf(at[A_IOR], 1.01f);

  float g[G_ROWS];
  g[G_POS] = ox + dx * best_t;
  g[G_POS + 1] = oy + dy * best_t;
  g[G_POS + 2] = oz + dz * best_t;
  g[G_NS] = nsx; g[G_NS + 1] = nsy; g[G_NS + 2] = nsz;
  g[G_NG] = ngx; g[G_NG + 1] = ngy; g[G_NG + 2] = ngz;
  g[G_BASE] = at[A_BASE]; g[G_BASE + 1] = at[A_BASE + 1]; g[G_BASE + 2] = at[A_BASE + 2];
  g[G_METAL] = at[A_METAL];
  g[G_ROUGH] = at[A_ROUGH];
  g[G_IOR] = ior;
  g[G_VALID] = hit ? 1.f : 0.f;
  g[G_DEPTH] = hit ? best_t : 0.f;
  g[G_WO] = -dx; g[G_WO + 1] = -dy; g[G_WO + 2] = -dz;
  g[G_EMISS] = at[A_EMISS] * le_gain;
  g[G_EMISS + 1] = at[A_EMISS + 1] * le_gain;
  g[G_EMISS + 2] = at[A_EMISS + 2] * le_gain;
  g[G_EM_PDF_AREA] = at[A_EM_PDF_AREA];
  g[G_UV] = w0 * at[A_UV0] + bu * at[A_UV1] + bv * at[A_UV2];
  g[G_UV + 1] = w0 * at[A_UV0 + 1] + bu * at[A_UV1 + 1] + bv * at[A_UV2 + 1];
  g[G_TEXID] = hit ? at[A_TEXID] : -1.f;
  g[G_TRANS] = at[A_TRANS];
  g[G_ETA] = front ? 1.f / ior : ior;
  g[G_COATW] = at[A_COATW];
  g[G_COATR] = at[A_COATR];
  g[G_MATID] = hit ? at[A_MATID] : -1.f;
  g[G_TANG] = at[A_TANG]; g[G_TANG + 1] = at[A_TANG + 1]; g[G_TANG + 2] = at[A_TANG + 2];
  g[G_UVDENS] = at[A_UVDENS];
  g[G_INST] = hit ? at[A_INSTID] : -1.f;
  for (int r = G_INST + 1; r < G_ROWS; ++r) g[r] = 0.f;
  // [40, n] output: thread i writes column i of every row (coalesced).
#pragma unroll
  for (int r = 0; r < G_ROWS; ++r) out[(size_t)r * n + i] = g[r];
}

}  // namespace

extern "C" int zr_gbuffer(const float* o, const float* d, const float* woop,
                          const float* attrs, float* out, int n, int tp, float t_min,
                          void* stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (grid > 0) {
    gbuffer_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(o, d, woop, attrs, out, n,
                                                              tp, t_min);
  }
  return (int)cudaGetLastError();
}
