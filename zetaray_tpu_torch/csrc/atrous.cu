// One pass of the edge-aware a-trous wavelet filter (ops/denoise.py
// atrous_iteration_plain): each pixel's 5x5 B3-spline taps at spacing
// `step`, weighted by luminance, normal and depth agreement and the taps'
// validity.
//
// Replaces no TPU kernel: the JAX a-trous (zetaray_tpu/ops/denoise.py) is
// XLA-side. It was added because the plain pass, 25 taps of four 2D
// torch.rolls (two launches each) and about 31 elementwise operations each,
// cost 3,953 launches a frame for the four passes.
//
// Bound: at 1920x1080 a pass reads 29 B a pixel (colour, normal, depth,
// the validity's bool byte) and writes 12 B, about 85 MB; its float work,
// 25 taps of two expf, a powf, an IEEE division and about 30 other
// operations, is of the same order at the card's float32 rate (0.027 ms a
// pass, counting a transcendental as one operation). The design reads each
// tap straight through L1/L2 (the ~60 MB of inputs fit the 50 MB L2
// mostly): one thread a pixel, blocks of 32 columns by 8 rows so that a
// warp's tap reads are one coalesced row segment; the 5 wrapped rows and 5
// wrapped columns are worked out once a pixel, the centre's luminance,
// normal and depth stay in registers, and no shared-memory tile is staged
// (at step 8 its halo would be 16 px a side, 90% of the tile). On an H100
// a pass takes 0.41 ms; other block shapes, 32-bit offsets or a 32-register
// cap move that by under 6%: the time is the accurate powf, expf and
// division the bit-equal result needs, not the reads.
//
// Float result: the same as the plain pass on the card, bit for bit. The
// taps run in the plain order (rows outer, from row y + 2 step; columns
// inner), each operation rounds on its own (--fmad=false) in the plain
// association, and PyTorch's CUDA arithmetic is matched: a tensor divided
// by a Python scalar is a multiply by the float reciprocal, a tensor by a
// tensor an IEEE division, exp and ** are expf and powf, clamp_min passes
// NaN through. The taps wrap as torch.roll does, a true modulo for any
// shift, so shifts larger than the image (tiny images, row bands) wrap too.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;  // a block's columns: one warp a row segment
constexpr int kTileH = 8;
constexpr int kBlock = kTileW * kTileH;

// the B3 spline's 1D weights (ops/denoise.py _B3)
__device__ __forceinline__ float b3(int k) {
  return k == 2 ? 3.0f / 8.0f : (k == 1 || k == 3) ? 1.0f / 4.0f : 1.0f / 16.0f;
}

// torch.clamp_min against a scalar: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// ops.post.luminance_p: (0.2126 r + 0.7152 g) + 0.0722 b
__device__ __forceinline__ float luminance(float r, float g, float b) {
  return (0.2126f * r + 0.7152f * g) + 0.0722f * b;
}

__device__ __forceinline__ int wrap(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// src, nrm [3, H, W] and dep, valid (bool bytes) [H, W] with their plane
// (ps) and row (rs) strides in elements, unit column stride; dst [3, H, W]
// contiguous. The validity weighs a tap as the plain pass's float 0 or 1.
__global__ void __launch_bounds__(kBlock)
atrous_pass_kernel(const float* __restrict__ src, long long src_ps, long long src_rs,
                   const float* __restrict__ nrm, long long nrm_ps, long long nrm_rs,
                   const float* __restrict__ dep, long long dep_rs,
                   const uint8_t* __restrict__ valid, long long val_rs,
                   float* __restrict__ dst, int h, int w, int step, float inv_sigma_color,
                   float sigma_normal, float sigma_depth) {
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int x = (int)(blockIdx.x % tiles_x) * kTileW + (int)(threadIdx.x % kTileW);
  const int y = (int)(blockIdx.x / tiles_x) * kTileH + (int)(threadIdx.x / kTileW);
  if (x >= w || y >= h) return;

  // tap (j, i) reads the roll by ((j - 2) step, (i - 2) step): pixel
  // (y - (j - 2) step, x - (i - 2) step), wrapped
  int ry[5], cx[5];
  for (int k = 0; k < 5; ++k) {
    ry[k] = wrap(y - (k - 2) * step, h);
    cx[k] = wrap(x - (k - 2) * step, w);
  }
  const long long sc = (long long)y * src_rs + x;
  const float cr = src[sc], cg = src[sc + src_ps], cb = src[sc + 2 * src_ps];
  const long long nc = (long long)y * nrm_rs + x;
  const float nx = nrm[nc], ny = nrm[nc + nrm_ps], nz = nrm[nc + 2 * nrm_ps];
  const float dc = dep[(long long)y * dep_rs + x];
  const bool vc = valid[(long long)y * val_rs + x] != 0;
  const float lum_c = luminance(cr, cg, cb);
  const float den = sigma_depth * clamp_min(dc, 1e-3f);

  float ar = 0.0f, ag = 0.0f, ab = 0.0f, wacc = 0.0f;
  for (int j = 0; j < 5; ++j) {
    const float wy = b3(j);
    const long long s_row = (long long)ry[j] * src_rs;
    const long long n_row = (long long)ry[j] * nrm_rs;
    const long long d_row = (long long)ry[j] * dep_rs;
    const long long v_row = (long long)ry[j] * val_rs;
    for (int i = 0; i < 5; ++i) {
      const float wx = b3(i);
      const long long s = s_row + cx[i];
      const long long n = n_row + cx[i];
      const float r = src[s], g = src[s + src_ps], b = src[s + 2 * src_ps];
      const float w_col = expf(-fabsf(luminance(r, g, b) - lum_c) * inv_sigma_color);
      const float n_dot = (nrm[n] * nx + nrm[n + nrm_ps] * ny) + nrm[n + 2 * nrm_ps] * nz;
      const float w_nrm = powf(clamp_min(n_dot, 0.0f), sigma_normal);
      const float w_dep = expf(-fabsf(dep[d_row + cx[i]] - dc) / den);
      const float v = valid[v_row + cx[i]] ? 1.0f : 0.0f;
      const float wgt = wy * wx * w_col * w_nrm * w_dep * v;
      ar = ar + r * wgt;
      ag = ag + g * wgt;
      ab = ab + b * wgt;
      wacc = wacc + wgt;
    }
  }
  const long long o = (long long)y * w + x;
  const long long plane = (long long)h * w;
  if (vc && wacc > 1e-6f) {
    const float q = clamp_min(wacc, 1e-6f);
    dst[o] = ar / q;
    dst[o + plane] = ag / q;
    dst[o + 2 * plane] = ab / q;
  } else {
    dst[o] = cr;
    dst[o + plane] = cg;
    dst[o + 2 * plane] = cb;
  }
}

}  // namespace

// One a-trous pass of src into dst (see the kernel). sigma_color is applied
// as its float reciprocal, as PyTorch on the card divides a tensor by a
// Python scalar.
extern "C" int zr_atrous(const float* src, long long src_ps, long long src_rs, const float* nrm,
                         long long nrm_ps, long long nrm_rs, const float* dep, long long dep_rs,
                         const uint8_t* valid, long long val_rs, float* dst, int h, int w,
                         int step, float sigma_color, float sigma_normal, float sigma_depth,
                         void* stream) {
  if (h < 0 || w < 0) return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)((w + kTileW - 1) / kTileW) * (long long)((h + kTileH - 1) / kTileH);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (tiles > 0) {
    atrous_pass_kernel<<<(int)tiles, kBlock, 0, (cudaStream_t)stream>>>(
        src, src_ps, src_rs, nrm, nrm_ps, nrm_rs, dep, dep_rs, valid, val_rs, dst, h, w, step,
        1.0f / sigma_color, sigma_normal, sigma_depth);
  }
  return (int)cudaGetLastError();
}
