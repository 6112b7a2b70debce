// ReSTIR DI initial candidates (B2): full-set RIS over a presampled light set.
//
// Replaces the TPU kernel _ris_kernel (zetaray_tpu/ops/restir_di.py). Pixel p
// uses light set (31 * (p / rt)) % n_sets, where rt is the JAX frame's tile
// width: that mapping is part of what the frame computes, so it is kept. The
// block's pixels divide rt, so they share one set. Each pixel rates the set's
// ps entries with the albedo/pi target, takes a sequential inclusive sum of
// the weights, draws one pcg4d uniform (salt 0x51E5, the stream of
// core.rng.uniform4) and picks the first entry whose running sum exceeds
// u * w_sum, else the last.
//
// The work is instructions, not bytes: 32 float operations a rating, two of
// them IEEE divisions of about ten instructions each, ps ratings a valid
// pixel, against 8 KB of set a block and 26 rows a pixel. So the design cuts
// ratings and shared-memory reads:
// - The block stages its set once as three 16-byte rows an entry:
//   {pos, lum(Le)}, {ng, max(pdf, 1e-12) where pdf > 0 else 0, negated for a
//   two-sided light} and {Le, the two-sided row}. A rating reads the first
//   two as broadcasts; the third is read once, for the picked entry.
// - One pixel a thread rates each entry once, and keeps the running sum at
//   the end of each of kCheckpoints chunks in registers. The
//   weights are >= 0, so the running sum never decreases and the pick lies in
//   the first chunk whose checkpoint exceeds u * w_sum: only that chunk is
//   rated again, from the previous checkpoint. Those are the sequential
//   sum's own additions in its order, so every output row equals that of the
//   version that rates every entry twice, bit for bit.
// - A pixel that is not valid has zero weights: it rates only the last
//   entry, whose target is its row 13.
#include "common.cuh"
#include "layout.h"  // G_*, LSET_ROWS, R_ROWS

namespace {

constexpr int kCheckpoints = 8;  // running sums kept (chunks of ceil(ps / 8) entries)

struct Surface {
  float px, py, pz, nx, ny, nz, base_l;
};

// RIS weight of the entry with staged rows (a, b) at the surface of a valid
// pixel; *phat_out gets its target. Each operation as the plain version
// orders it.
__device__ __forceinline__ float rate(const float4 a, const float4 b, const Surface& sf,
                                      float* phat_out) {
  const float tx = a.x - sf.px;
  const float ty = a.y - sf.py;
  const float tz = a.z - sf.pz;
  const float dist2 = fmaxf(tx * tx + ty * ty + tz * tz, 1e-12f);
  const float inv_d = rsqrtf(dist2);
  const float cos_surf = (tx * sf.nx + ty * sf.ny + tz * sf.nz) * inv_d;
  const float cos_l_raw = -(tx * b.x + ty * b.y + tz * b.z) * inv_d;
  const float cos_l = signbit(b.w) ? fabsf(cos_l_raw) : cos_l_raw;
  float phat = sf.base_l * a.w * cos_surf * cos_l / dist2;
  phat = (cos_surf > 1e-6f && cos_l > 1e-6f) ? fmaxf(phat, 0.f) : 0.f;
  *phat_out = phat;
  const float pdf = fabsf(b.w);
  return pdf > 0.f ? phat / pdf : 0.f;
}

__global__ void ris_kernel(const float* __restrict__ gb, const float* __restrict__ sets,
                           float* __restrict__ out, int n, int n_sets, int ps, int rt,
                           uint32_t seed, int pix0) {
  extern __shared__ float4 s4[];  // [3][ps]
  float4* const s_a = s4;
  float4* const s_b = s4 + ps;
  float4* const s_c = s4 + 2 * ps;
  const int p0 = blockIdx.x * blockDim.x;
  // the global tile of a row band's pixel: pix0 / rt tiles precede the band
  const int set = (int)((((long long)(pix0 / rt) + p0 / rt) * 31) % n_sets);
  const float* src = sets + (size_t)set * LSET_ROWS * ps;
  for (int k = threadIdx.x; k < ps; k += blockDim.x) {
    const float lum = 0.2126f * src[6 * ps + k] + 0.7152f * src[7 * ps + k] +
                      0.0722f * src[8 * ps + k];
    const float pdf = src[9 * ps + k];
    const float pdf_c = pdf > 0.f ? fmaxf(pdf, 1e-12f) : 0.f;
    const float two = src[10 * ps + k];
    s_a[k] = float4{src[0 * ps + k], src[1 * ps + k], src[2 * ps + k], lum};
    s_b[k] = float4{src[3 * ps + k], src[4 * ps + k], src[5 * ps + k],
                    two > 0.5f ? -pdf_c : pdf_c};  // -0 for a two-sided entry of pdf 0
    s_c[k] = float4{src[6 * ps + k], src[7 * ps + k], src[8 * ps + k], two};
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
  const bool valid = gb[(size_t)G_VALID * n + i] > 0.5f;

  // the one full pass, keeping the running sum at the end of each chunk
  const int chunk = (ps + kCheckpoints - 1) / kCheckpoints;
  float w_sum = 0.f, cp[kCheckpoints];
  if (valid) {
#pragma unroll
    for (int c = 0; c < kCheckpoints; ++c) {
      const int hi = min(ps, (c + 1) * chunk);
      for (int k = c * chunk; k < hi; ++k) {
        float phat;
        w_sum = w_sum + rate(s_a[k], s_b[k], sf, &phat);
      }
      cp[c] = w_sum;
    }
  }

  uint32_t h0 = (uint32_t)pix0 + (uint32_t)i, h1 = 0u, h2 = seed, h3 = 0x51E5u;
  zr::pcg4d(h0, h1, h2, h3);
  const float target = zr::to_unit(h0) * w_sum;
  int idx = ps - 1;
  float y_phat = 0.f;
  if (valid) {
    // the first chunk whose checkpoint exceeds the target, and the running
    // sum before it
    int first = kCheckpoints;
    float cum = 0.f;
#pragma unroll
    for (int c = 0; c < kCheckpoints; ++c) {
      if (first == kCheckpoints) {
        if (cp[c] > target) {
          first = c;
        } else {
          cum = cp[c];
        }
      }
    }
    if (first < kCheckpoints) {
      const int hi = min(ps, (first + 1) * chunk);
      for (int k = first * chunk; k < hi; ++k) {
        float phat;
        cum = cum + rate(s_a[k], s_b[k], sf, &phat);
        if (cum > target) {
          idx = k;
          y_phat = phat;
          break;
        }
      }
    }
  }
  if (idx == ps - 1) rate(s_a[idx], s_b[idx], sf, &y_phat);

  const float m_count = (float)ps;
  const float big_w = y_phat > 0.f ? w_sum / fmaxf(m_count * y_phat, 1e-12f) : 0.f;
  const float4 a = s_a[idx], b = s_b[idx], e = s_c[idx];
  float r[R_ROWS] = {a.x, a.y, a.z, b.x, b.y, b.z, e.x, e.y, e.z, w_sum, m_count, big_w, e.w,
                     y_phat};  // the rest 0
#pragma unroll
  for (int k = 0; k < R_ROWS; ++k) out[(size_t)k * n + i] = r[k];
}

}  // namespace

// block: pixels (threads) a block; it must divide the tile width rt.
// pix0: the global id of the first pixel (a row band's offset; 0 for the
// whole image), which moves the pixels' tiles and random streams.
extern "C" int zr_ris(const float* gb, const float* sets, float* out, int n, int n_sets, int ps,
                      int rt, int block, uint32_t seed, int pix0, void* stream) {
  if (n_sets < 1 || ps < 1 || block < 1 || rt % block || pix0 < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = (n + block - 1) / block;
  const size_t smem = (size_t)3 * ps * sizeof(float4);
  if (grid > 0) {
    ris_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(gb, sets, out, n, n_sets, ps, rt,
                                                             seed, pix0);
  }
  return (int)cudaGetLastError();
}
