// Device functions of one path bounce, shared by the three kernels of
// bounce.cu (zetaray_tpu_torch.accel.megakernel.bounce_trace/_shade/bounce):
// the trace half after the closest-hit sweep (surface_at) and the shade half
// before the shadow sweeps (shade_sample), with the closed-form sky of
// ops/sky.py (sky_env) for rays that miss. The BSDF's transmission and coat
// lobes are a compile-time branch (kMat) of bsdf_eval, bsdf_sample and
// shade_sample; within it the scene's flags (Mat::has_trans, has_coat) pick
// the lobes at run time, as ops/shading_soa.py's None fields do.
//
// Every function follows its PyTorch counterpart operation for operation
// (ops/shading_soa.py, accel/megakernel.py), and the library is built with
// --fmad=false and without fast math, so each float operation rounds as it
// does there. Constants that the Python code writes as double literals are
// written here as (float) casts of the same literals.
//
// Path state rows (STATE_ROWS): 0-2 o | 3-5 d | 6-8 throughput | 9-11
// radiance | 12 prev_bsdf_pdf | 13 alive | 14 specular flag | 15 cone width.
#pragma once

#include "common.cuh"
#include "layout.h"  // A_*, EA_*, BOUNCE_SALT, WOPS_SALT, WOPS_ROW, PATH_OPTS, STATE_ROWS,
                     // SURF_ROWS, GGX_*, SKY_*

namespace zr {

struct V3f {
  float x, y, z;
};

__device__ __forceinline__ V3f operator+(V3f a, V3f b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3f operator-(V3f a, V3f b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3f operator*(V3f a, V3f b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3f operator*(V3f a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3f operator-(V3f a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3f a, V3f b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3f cross(V3f a, V3f b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3f normalize(V3f a, float eps) {
  return a * rsqrtf(fmaxf(dot(a, a), eps));
}
__device__ __forceinline__ float luminance(V3f a) {
  return (float)0.2126 * a.x + (float)0.7152 * a.y + (float)0.0722 * a.z;
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float power_heuristic(float a, float b) {
  const float a2 = a * a;
  return a2 / fmaxf(a2 + b * b, 1e-20f);
}

// The path regularization of a roughness (ops/pathtracer.py regularize): GGX
// alpha below 0.25 becomes clamp(2 alpha, 0.1, 0.25).
__device__ __forceinline__ float regularize(float rough) {
  const float alpha = rough * rough;
  return sqrtf(alpha < 0.25f ? clampf(2.f * alpha, 0.1f, 0.25f) : alpha);
}

// One PTConfig.sky as the kernels read it (ops/sky.py kernel_constants).
struct Sky {
  V3f sun;          // unit, toward the sun
  float intensity;  // the sky's scale
  float cos_r;      // cos of the disk's angular radius
  float den;        // max(1e-6, 1 - cos_r), the width of the disk's edge
  V3f color;        // SUN_COLOR
  V3f e_sun;        // the sun's irradiance (sun_irradiance)
};

// The sun disk's radiance toward d before SUN_COLOR, a smooth-edged disk
// (ops/sky.py sun_disk).
__device__ __forceinline__ float sun_disk(V3f d, const Sky& s) {
  return clampf((dot(d, s.sun) - s.cos_r) / s.den * 4.f, 0.f, 1.f) * s.intensity * SKY_SUN_SCALE;
}

// The closed-form sky without the sun disk toward d (ops/sky.py
// sky_radiance with with_disk=False).
__device__ __forceinline__ V3f sky_env(V3f d, const Sky& s) {
  const float c = clampf(dot(d, s.sun), -1.f, 1.f);
  const float up = clampf(d.y, -1.f, 1.f);
  const float m = 1.f / fmaxf(up * 0.8f + 0.22f, 0.05f);  // an optical-depth proxy
  const float ray = SKY_RAYLEIGH * (1.f + c * c) * m;
  const float den = SKY_MIE_A - SKY_MIE_B * c;
  const float mie = SKY_MIE_NUM / (SKY_FOUR_PI * den * sqrtf(fmaxf(den, 1e-6f))) * m * SKY_MIE_K;
  const float scale = s.intensity * clampf((up + 0.08f) * 12.f, 0.f, 1.f);
  return {(ray * SKY_BETA_R0 + mie) * scale, (ray * SKY_BETA_R1 + mie) * scale,
          (ray * SKY_BETA_R2 + mie) * scale};
}

constexpr double kPi = 3.141592653589793;  // math.pi
constexpr float kPi32 = (float)3.14159265;  // the literal of _ggx_d and _ms_lobe
constexpr float kInvPi = (float)(1.0 / 3.14159265358979);
constexpr float kEpsRay = (float)1e-3;

// ---------------------------------------------------------------------------
// BSDF (ops/shading_soa.py): Lambert + GGX reflection with the Kulla-Conty
// multiscatter lobe; with kMat also the rough dielectric transmission
// (Walter 2007) where has_trans, and the coat layer where has_coat.
// ---------------------------------------------------------------------------

struct Mat {
  V3f base;
  float metallic, roughness, ior;
  // read by the kMat branches only: the transmission weight and the relative
  // IOR along the ray (has_trans), the coat's weight and roughness (has_coat)
  float trans, eta, coat, coat_rough;
  bool has_trans, has_coat;
};

constexpr float kCoatF0 = (float)0.04;  // the coat's IOR 1.5 (_COAT_F0)

struct Frame {
  V3f t, b, n;
  __device__ __forceinline__ V3f to_local(V3f w) const { return {dot(w, t), dot(w, b), dot(w, n)}; }
  __device__ __forceinline__ V3f to_world(V3f w) const { return t * w.x + b * w.y + n * w.z; }
};

__device__ __forceinline__ Frame make_frame(V3f n) {
  const float s = n.z >= 0.f ? 1.f : -1.f;
  const float a = -1.f / (s + n.z);
  const float b = n.x * n.y * a;
  Frame f;
  f.t = {1.f + s * n.x * n.x * a, s * b, -s * n.x};
  f.b = {b, s + n.y * n.y * a, -n.y};
  f.n = n;
  return f;
}

__device__ __forceinline__ V3f fresnel(V3f f0, float cos_h) {
  const float m = clampf(1.f - cos_h, 0.f, 1.f);
  const float m5 = (m * m) * (m * m) * m;
  return f0 + V3f{1.f - f0.x, 1.f - f0.y, 1.f - f0.z} * m5;
}

__device__ __forceinline__ float ggx_d(float a2, float cos_h) {
  const float c2 = cos_h * cos_h;
  const float den = c2 * (a2 - 1.f) + 1.f;
  return a2 / fmaxf(kPi32 * den * den, 1e-12f);
}

__device__ __forceinline__ float smith_lambda(float a2, float cos_t) {
  const float c2 = clampf(cos_t * cos_t, 1e-8f, 1.f);
  return 0.5f * (sqrtf(1.f + a2 * (1.f - c2) / c2) - 1.f);
}

// Fitted single-scatter GGX directional albedo E(cos_o, roughness).
__device__ __forceinline__ float ggx_albedo(float cos_o, float rough) {
  const float mi = clampf(cos_o, 0.02f, 1.f);
  const float ai = clampf(rough, 0.04f, 1.f);
  float out = 0.f, mp = 1.f;
  int idx = 0;
#pragma unroll
  for (int i = 0; i <= GGX_E_DEG; ++i) {
    float ap = 1.f;
#pragma unroll
    for (int j = 0; j <= GGX_E_DEG; ++j) {
      out = out + GGX_E_COEF[idx] * mp * ap;
      ++idx;
      ap = ap * ai;
    }
    mp = mp * mi;
  }
  return clampf(out, 0.05f, 1.f);
}

// Fitted cosine-weighted average albedo E_avg(roughness).
__device__ __forceinline__ float ggx_albedo_avg(float rough) {
  const float ai = clampf(rough, 0.04f, 1.f);
  float out = 0.f, ap = 1.f;
#pragma unroll
  for (int k = 0; k < GGX_E_DEG + 2; ++k) {
    out = out + GGX_EAVG_COEF[k] * ap;
    ap = ap * ai;
  }
  return clampf(out, 0.05f, 1.f);
}

__device__ __forceinline__ V3f ms_lobe(V3f f0, float rough, float cos_o, float cos_i) {
  const float e_o = ggx_albedo(cos_o, rough);
  const float e_i = ggx_albedo(cos_i, rough);
  const float e_avg = ggx_albedo_avg(rough);
  const float ms = (1.f - e_o) * (1.f - e_i) / (kPi32 * fmaxf(1.f - e_avg, 1e-4f));
  const V3f f_avg = f0 + V3f{1.f - f0.x, 1.f - f0.y, 1.f - f0.z} * (float)(1.0 / 21.0);
  auto fres = [e_avg](float fa) {
    return fa * fa * e_avg / fmaxf(1.f - fa * (1.f - e_avg), 1e-4f);
  };
  return {ms * fres(f_avg.x), ms * fres(f_avg.y), ms * fres(f_avg.z)};
}

struct Lobes {
  float alpha, q_s, q_d, q_t;  // q_t: with kMat and has_trans only
  V3f f0, kd, kt;
};

template <bool kMat>
__device__ __forceinline__ Lobes lobes(const Mat& m, float cos_o) {
  Lobes l;
  l.alpha = fmaxf(m.roughness * m.roughness, 1e-4f);
  const float r = (m.ior - 1.f) / (m.ior + 1.f);
  const float f0d = r * r;
  l.f0 = {f0d * (1.f - m.metallic) + m.base.x * m.metallic,
          f0d * (1.f - m.metallic) + m.base.y * m.metallic,
          f0d * (1.f - m.metallic) + m.base.z * m.metallic};
  if (kMat && m.has_trans) {
    l.kd = m.base * ((1.f - m.metallic) * (1.f - m.trans));
    l.kt = m.base * ((1.f - m.metallic) * m.trans);
    const float s = luminance(fresnel(l.f0, cos_o));
    const float d = luminance(l.kd);
    const float t = luminance(l.kt);
    const float tot = fmaxf(s + d + t, 1e-8f);
    l.q_s = clampf(s / tot, 0.05f, 1.f);
    l.q_t = fminf(t / tot * (1.f - l.q_s) / fmaxf(1.f - s / tot, 1e-8f), 1.f - l.q_s);
    l.q_d = fmaxf(1.f - l.q_s - l.q_t, 0.f);
    return l;
  }
  l.kd = m.base * (1.f - m.metallic);
  const float s = luminance(fresnel(l.f0, cos_o));
  const float d = luminance(l.kd);
  l.q_s = clampf(s / fmaxf(s + d, 1e-8f), 0.05f, 1.f);
  l.q_d = 1.f - l.q_s;
  return l;
}

// Schlick Fresnel of a scalar f0 (_fresnel_s).
__device__ __forceinline__ float fresnel_s(float f0, float cos_h) {
  const float m = clampf(1.f - cos_h, 0.f, 1.f);
  const float m5 = (m * m) * (m * m) * m;
  return f0 + (1.f - f0) * m5;
}

// Exact unpolarized dielectric Fresnel, eta = eta_i / eta_t; 1 at total
// internal reflection (_fresnel_scalar_dielectric).
__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta) {
  cos_i = clampf(cos_i, 0.f, 1.f);
  const float sin2_t = eta * eta * (1.f - cos_i * cos_i);
  const float cos_t = sqrtf(fmaxf(1.f - sin2_t, 0.f));
  const float r_par = (cos_i - eta * cos_t) / fmaxf(cos_i + eta * cos_t, 1e-8f);
  const float r_perp = (eta * cos_i - cos_t) / fmaxf(eta * cos_i + cos_t, 1e-8f);
  const float f = 0.5f * (r_par * r_par + r_perp * r_perp);
  return sin2_t >= 1.f ? 1.f : clampf(f, 0.f, 1.f);
}

// The coat's sampling probability (_coat_q).
__device__ __forceinline__ float coat_q(const Mat& m, float cos_o) {
  return clampf(m.coat * fresnel_s(kCoatF0, cos_o) * 2.f, 0.f, 0.5f);
}

// The rough dielectric BTDF and its half-vector pdf for wi.z < 0
// (_transmission_terms): returns f_t, *pdf the pdf before the lobe's pick.
__device__ __forceinline__ V3f transmission_terms(const Mat& m, V3f wo, V3f wi, float alpha,
                                                  V3f kt, float* pdf) {
  const float inv_eta = 1.f / m.eta;
  const float a2 = alpha * alpha;
  const float cos_o = fmaxf(wo.z, 1e-6f);
  const float cos_i = fmaxf(-wi.z, 1e-6f);
  V3f h = normalize(wo + wi * inv_eta, 1e-24f);
  if (h.z < 0.f) h = -h;
  const float odoth = dot(wo, h);
  const float idoth = dot(wi, h);
  const bool valid = (odoth > 1e-6f) && (idoth < -1e-6f);
  const float dt = ggx_d(a2, clampf(h.z, 0.f, 1.f));
  const float lam_o = smith_lambda(a2, cos_o);
  const float g2 = 1.f / (1.f + lam_o + smith_lambda(a2, cos_i));
  const float fr = fresnel_dielectric(odoth, m.eta);
  const float denom = odoth + inv_eta * idoth;
  const float denom2 = fmaxf(denom * denom, 1e-12f);
  const float scale =
      (1.f - fr) * dt * g2 * fabsf(idoth) * fabsf(odoth) / (cos_o * cos_i * denom2);
  const float dwh_dwi = fabsf(idoth) * (inv_eta * inv_eta) / denom2;
  const float pdf_t = (1.f / (1.f + lam_o)) * dt * fmaxf(odoth, 0.f) / cos_o * dwh_dwi;
  *pdf = valid ? pdf_t : 0.f;
  return kt * (valid ? scale : 0.f);
}

// (f, *pdf) for directions in the local frame; zero below the surface
// unless kMat and has_trans.
template <bool kMat>
__device__ __forceinline__ V3f bsdf_eval(const Mat& m, V3f wo, V3f wi, float* pdf) {
  const float cos_o = fmaxf(wo.z, 1e-6f);
  const Lobes l = lobes<kMat>(m, cos_o);
  const float a2 = l.alpha * l.alpha;
  const bool up = wi.z > 1e-6f;
  const float cos_i = fmaxf(wi.z, 1e-6f);
  const V3f h = normalize(wo + wi, 1e-24f);
  const float cos_h = clampf(h.z, 0.f, 1.f);
  const float odoth = fmaxf(dot(wo, h), 1e-6f);
  const float dt = ggx_d(a2, cos_h);
  const float g2 = 1.f / (1.f + smith_lambda(a2, cos_o) + smith_lambda(a2, cos_i));
  const V3f fr = fresnel(l.f0, odoth);
  const V3f f_ms = ms_lobe(l.f0, m.roughness, cos_o, cos_i);
  const V3f f_refl = fr * (dt * g2 / (4.f * cos_o * cos_i)) + f_ms + l.kd * kInvPi;
  const float pdf_spec = (1.f / (1.f + smith_lambda(a2, cos_o))) * dt / (4.f * cos_o);
  const float pdf_refl = l.q_s * pdf_spec + l.q_d * (cos_i * kInvPi);
  if constexpr (!kMat) {
    *pdf = up ? pdf_refl : 0.f;
    return up ? f_refl : V3f{0.f, 0.f, 0.f};
  } else {
    V3f f_up = f_refl;
    float pdf_up = pdf_refl, fc_o = 0.f, q_c = 0.f;
    if (m.has_coat) {
      const float cw = m.coat;
      const float ca = fmaxf(m.coat_rough * m.coat_rough, 1e-4f);
      const float ca2 = ca * ca;
      q_c = coat_q(m, cos_o);
      fc_o = cw * fresnel_s(kCoatF0, cos_o);
      const float fc_i = cw * fresnel_s(kCoatF0, cos_i);
      const float dt_c = ggx_d(ca2, cos_h);
      const float lam_c = smith_lambda(ca2, cos_o);
      const float g2_c = 1.f / (1.f + lam_c + smith_lambda(ca2, cos_i));
      const float f_coat =
          cw * fresnel_s(kCoatF0, odoth) * dt_c * g2_c / (4.f * cos_o * cos_i);
      const float att = (1.f - fc_o) * (1.f - fc_i);
      f_up = {f_coat + att * f_refl.x, f_coat + att * f_refl.y, f_coat + att * f_refl.z};
      const float pdf_coat = (1.f / (1.f + lam_c)) * dt_c / (4.f * cos_o);
      pdf_up = q_c * pdf_coat + (1.f - q_c) * pdf_refl;
    }
    if (!m.has_trans) {
      *pdf = up ? pdf_up : 0.f;
      return up ? f_up : V3f{0.f, 0.f, 0.f};
    }
    const bool down = wi.z < -1e-6f;
    float pdf_tr;
    V3f f_tr = transmission_terms(m, wo, wi, l.alpha, l.kt, &pdf_tr);
    if (m.has_coat) {
      // the coat attenuates the transmitted energy on both interfaces
      f_tr = f_tr * ((1.f - fc_o) * (1.f - m.coat * fresnel_s(kCoatF0, fmaxf(-wi.z, 1e-6f))));
      pdf_tr = (1.f - q_c) * l.q_t * pdf_tr;
    } else {
      pdf_tr = l.q_t * pdf_tr;
    }
    *pdf = up ? pdf_up : (down ? pdf_tr : 0.f);
    return up ? f_up : (down ? f_tr : V3f{0.f, 0.f, 0.f});
  }
}

__device__ __forceinline__ V3f cosine_hemisphere(float u1, float u2) {
  const float a = 2.f * u1 - 1.f;
  const float b = 2.f * u2 - 1.f;
  const bool cond = fabsf(a) > fabsf(b);
  const float r = cond ? a : b;
  const float safe = r == 0.f ? 1.f : r;
  float phi = cond ? (float)(kPi / 4.0) * (b / safe)
                   : (float)(kPi / 2.0) - (float)(kPi / 4.0) * (a / safe);
  if (r == 0.f) phi = 0.f;
  const float x = r * cosf(phi);
  const float y = r * sinf(phi);
  return {x, y, sqrtf(fmaxf(1.f - x * x - y * y, 0.f))};
}

__device__ __forceinline__ V3f ggx_vndf(V3f wo, float alpha, float u1, float u2) {
  const V3f v = normalize(V3f{wo.x * alpha, wo.y * alpha, wo.z}, 1e-20f);
  const float lensq = v.x * v.x + v.y * v.y;
  const float safe = rsqrtf(fmaxf(lensq, 1e-20f));
  const bool big = lensq > 1e-12f;
  const V3f t1 = {big ? -v.y * safe : 1.f, big ? v.x * safe : 0.f, 0.f};
  const V3f t2 = cross(v, t1);
  const float r = sqrtf(u1);
  const float phi = (float)(2.0 * kPi) * u2;
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float s = 0.5f * (1.f + v.z);
  p2 = (1.f - s) * sqrtf(fmaxf(1.f - p1 * p1, 0.f)) + s * p2;
  const float p3 = sqrtf(fmaxf(1.f - p1 * p1 - p2 * p2, 0.f));
  const V3f nh = t1 * p1 + t2 * p2 + v * p3;
  return normalize(V3f{alpha * nh.x, alpha * nh.y, fmaxf(nh.z, 1e-6f)}, 1e-20f);
}

// Sample wi from the lobe mixture (without kMat: GGX reflection or diffuse;
// with it the coat first, at probability coat_q, then the base mixture on u1
// rescaled, with the transmission lobe where has_trans; a transmission pick
// at total internal reflection is killed); *wgt = f |cos| / pdf, *pdf.
template <bool kMat>
__device__ __forceinline__ V3f bsdf_sample(const Mat& m, V3f wo, float u1, float u2, float u3,
                                           V3f* wgt, float* pdf) {
  const float cos_o = fmaxf(wo.z, 1e-6f);
  const Lobes l = lobes<kMat>(m, cos_o);
  if constexpr (!kMat) {
    const V3f h = ggx_vndf(wo, l.alpha, u2, u3);
    const V3f wi_spec = h * (2.f * dot(wo, h)) - wo;
    const V3f wi = u1 < l.q_s ? wi_spec : cosine_hemisphere(u2, u3);
    float p;
    const V3f f = bsdf_eval<false>(m, wo, wi, &p);
    const bool good = (p > 1e-12f) && (wi.z > 1e-6f);
    const float scale = good ? fabsf(wi.z) / fmaxf(p, 1e-12f) : 0.f;
    *wgt = f * scale;
    *pdf = good ? p : 0.f;
    return wi;
  }
  bool pick_coat = false;
  V3f wi_coat;
  if (m.has_coat) {
    const float q_c = coat_q(m, cos_o);
    pick_coat = u1 < q_c;
    u1 = clampf((u1 - q_c) / fmaxf(1.f - q_c, 1e-6f), 0.f, 1.f);
    const V3f h_c = ggx_vndf(wo, fmaxf(m.coat_rough * m.coat_rough, 1e-4f), u2, u3);
    wi_coat = h_c * (2.f * dot(wo, h_c)) - wo;
  }
  const V3f h = ggx_vndf(wo, l.alpha, u2, u3);
  const V3f wi_spec = h * (2.f * dot(wo, h)) - wo;
  const bool pick_spec = u1 < l.q_s;
  bool below = false, tir = false;  // a transmission pick, and total internal reflection
  V3f wi;
  if (m.has_trans) {
    below = !pick_spec && u1 < l.q_s + l.q_t;
    // refraction through the sampled half vector
    const float odoth = dot(wo, h);
    const float sin2_t = m.eta * m.eta * (1.f - odoth * odoth);
    tir = sin2_t >= 1.f;
    const float cos_t = sqrtf(fmaxf(1.f - sin2_t, 0.f));
    wi = pick_spec ? wi_spec
                   : (below ? h * (m.eta * odoth - cos_t) - wo * m.eta
                            : cosine_hemisphere(u2, u3));
  } else {
    wi = pick_spec ? wi_spec : cosine_hemisphere(u2, u3);
  }
  if (pick_coat) {
    wi = wi_coat;
    below = false;
  }
  float p;
  const V3f f = bsdf_eval<kMat>(m, wo, wi, &p);
  const bool hemi_ok = below ? (wi.z < -1e-6f && !tir) : wi.z > 1e-6f;
  const bool good = (p > 1e-12f) && hemi_ok;
  const float scale = good ? fabsf(wi.z) / fmaxf(p, 1e-12f) : 0.f;
  *wgt = f * scale;
  *pdf = good ? p : 0.f;
  return wi;
}

// ---------------------------------------------------------------------------
// The bounce
// ---------------------------------------------------------------------------

struct Path {
  V3f o, d, thr, rad;
  float prev_pdf, spec, cone;
  bool alive;
};

__device__ __forceinline__ Path load_path(const float* __restrict__ st, int n, int i) {
  auto r = [&](int k) { return st[(size_t)k * n + i]; };
  Path p;
  p.o = {r(0), r(1), r(2)};
  p.d = {r(3), r(4), r(5)};
  p.thr = {r(6), r(7), r(8)};
  p.rad = {r(9), r(10), r(11)};
  p.prev_pdf = r(12);
  p.alive = r(13) > 0.5f;
  p.spec = r(14);
  p.cone = r(15);
  return p;
}

__device__ __forceinline__ void store_path(float* __restrict__ st, int n, int i, const Path& p) {
  const float v[STATE_ROWS] = {p.o.x, p.o.y, p.o.z, p.d.x, p.d.y, p.d.z,
                               p.thr.x, p.thr.y, p.thr.z, p.rad.x, p.rad.y, p.rad.z,
                               p.prev_pdf, p.alive ? 1.f : 0.f, p.spec, p.cone};
#pragma unroll
  for (int k = 0; k < STATE_ROWS; ++k) st[(size_t)k * n + i] = v[k];
}

// What one bounce's kernel is told (accel.megakernel wrappers, PTConfig).
struct BounceParams {
  int bounce;
  uint32_t seed;
  // light-set tiling: ray i takes set (tile0 + i / rt + 13 * bounce) % n_sets;
  // pix0 is the global id of ray 0 (a row band's offset, 0 for the whole
  // image), tile0 = pix0 / rt, and ray i's random stream is pix0 + i
  int rt, n_sets, ps;
  int pix0, tile0;
  int n_em;  // WoPS NEE: the real emissives of the table (ps its rows)
  float t_min;
  int min_emissive_bounce, min_nee_bounce, rr_start;
  bool nee, has_lights;
  // the path options (accel.megakernel.path_options); the sky's and the
  // sun's branches are compile-time flags of the kernels, sun_nee gates the
  // sun disk on a miss
  float firefly;  // 0: off; else the most a NEE sample adds
  bool path_reg, sun_nee;
  // the scene's material lobes (accel.megakernel.material_flags), read by
  // the kMat instances only
  bool has_trans, has_coat;
  Sky sky;
};

// The path options block of PATH_OPTS floats (accel.megakernel.path_options;
// a host array, or null for none) into p.
inline void set_path_options(BounceParams& p, const float* opts) {
  float o[PATH_OPTS] = {};
  if (opts != nullptr) {
    for (int k = 0; k < PATH_OPTS; ++k) o[k] = opts[k];
  }
  p.firefly = o[0];
  p.path_reg = o[1] != 0.f;
  p.sun_nee = o[3] != 0.f;
  p.sky = {{o[4], o[5], o[6]}, o[7], o[8], o[9], {o[10], o[11], o[12]}, {o[13], o[14], o[15]}};
}

// Whether the path options ask for the sky (its kernels' branch) and sun NEE.
inline bool opts_sky(const float* opts) { return opts != nullptr && opts[2] != 0.f; }
inline bool opts_sun_nee(const float* opts) { return opts != nullptr && opts[3] != 0.f; }

// The hit surface: what the trace half hands to the shade half (the
// SURF_ROWS of the split kernels).
struct Surface {
  V3f pos, ns, ng;
  Mat mat;
  float eta;
};

// The light set of the tile that holds ray p0 at this bounce.
__device__ __forceinline__ int bounce_set(const BounceParams& prm, int p0) {
  return (int)(((long long)(prm.tile0 + p0 / prm.rt) + 13LL * prm.bounce) % prm.n_sets);
}

// The trace half of B4 and B6 after their closest-hit sweep (sweep.cuh),
// from the hit (t_hit, tri, bu, bv; tri -1 on a miss): with kSky the sky
// and the sun disk where a live ray missed (the disk only on a specular ray
// when NEE samples the sun), MIS-weighted emission gated by
// min_emissive_bounce, alive = found, and the surface rebuilt at the hit,
// with kMat its transmission and coat too.
template <bool kSky, bool kMat = false>
__device__ __forceinline__ void surface_at(const float* __restrict__ attrs,
                                           const BounceParams& prm, float t_hit, int tri,
                                           float bu, float bv, Path& path, Surface& sf) {
  const bool hit = tri >= 0;
  const float* row = attrs + (size_t)(hit ? tri : 0) * A_WIDTH;
  auto at = [&](int k) { return hit ? row[k] : 0.f; };
  auto at3 = [&](int k) { return V3f{at(k), at(k + 1), at(k + 2)}; };

  const bool found = hit && path.alive;
  if constexpr (kSky) {
    const Sky& s = prm.sky;
    const V3f env = sky_env(path.d, s);
    float disk = sun_disk(path.d, s);
    if (prm.sun_nee) disk = disk * (path.spec > 0.5f ? 1.f : 0.f);
    const float gain = (path.alive && !hit) ? 1.f : 0.f;
    path.rad = path.rad + path.thr * V3f{(env.x + disk * s.color.x) * gain,
                                         (env.y + disk * s.color.y) * gain,
                                         (env.z + disk * s.color.z) * gain};
  }
  const V3f ng_raw = at3(A_NG);
  const float wo_dot_ng = -dot(path.d, ng_raw);
  if (prm.has_lights) {
    const bool vis_side = (at(A_DOUBLE) > 0.5f) || (wo_dot_ng > 0.f);
    const float pdf_l_sa = at(A_EM_PDF_AREA) * t_hit * t_hit / fmaxf(fabsf(wo_dot_ng), 1e-8f);
    const float mis = !prm.nee ? 1.f
                      : (path.spec > 0.5f ? 1.f : power_heuristic(path.prev_pdf, pdf_l_sa));
    float gain = (found && vis_side) ? mis : 0.f;
    if (prm.bounce < prm.min_emissive_bounce) gain = 0.f;
    path.rad = path.rad + path.thr * at3(A_EMISS) * gain;
  }
  path.alive = found;

  const float w0 = 1.f - bu - bv;
  V3f ns = normalize(at3(A_N0) * w0 + at3(A_N1) * bu + at3(A_N2) * bv, 1e-20f);
  const bool front = wo_dot_ng > 0.f;
  const float sgn = front ? 1.f : -1.f;
  sf.ng = ng_raw * sgn;
  ns = ns * sgn;
  sf.ns = dot(ns, sf.ng) < 0.f ? -ns : ns;
  sf.pos = path.o + path.d * t_hit;
  const float ior = fmaxf(at(A_IOR), 1.01f);
  sf.mat = {at3(A_BASE), at(A_METAL), at(A_ROUGH), ior};
  sf.eta = front ? 1.f / ior : ior;
  if constexpr (kMat) {
    sf.mat.trans = at(A_TRANS);
    sf.mat.eta = sf.eta;
    sf.mat.coat = at(A_COATW);
    sf.mat.coat_rough = at(A_COATR);
  }
}

// One NEE light sample: its position, normal, emitted radiance, pdf per
// area and whether it is two-sided.
struct LightSample {
  V3f p, ng, le;
  float pdf_area;
  bool two_sided;
};

// Entry k of the light set staged at lset (LSET_STAGED rows of prm.ps).
__device__ __forceinline__ LightSample set_light(const float* lset, const BounceParams& prm,
                                                 int k) {
  auto ls = [&](int r) { return lset[r * prm.ps + k]; };
  return {{ls(0), ls(1), ls(2)}, {ls(3), ls(4), ls(5)}, {ls(6), ls(7), ls(8)}, ls(9),
          ls(10) > 0.5f};
}

// WoPS NEE's light sample for ray i (accel.megakernel._wops_light): a second
// pcg4d (i, bounce, seed, WOPS_SALT) gives the alias test and the point on
// the triangle; pick u_pick over the prm.n_em real emissives, resolve it
// through the alias entry {prob, alias} of the pick's row and read the
// chosen light's row. tab: accel.megakernel.wops_table in global memory,
// rows of WOPS_ROW floats, one 128-byte line each: the alias entry is one
// 8-byte word through the read-only path, the light 17 floats of its line.
// (Its row read as 16-byte words held more registers: B5 and B6 spilled
// more than their light-set instances.)
__device__ __forceinline__ LightSample wops_light(const float* __restrict__ tab,
                                                  const BounceParams& prm, int i, float u_pick) {
  static_assert(WOPS_ROW % 2 == 0 && EA_WIDTH % 2 == 0, "the alias entry is an 8-byte word");
  uint32_t h0 = (uint32_t)prm.pix0 + (uint32_t)i, h1 = (uint32_t)prm.bounce;
  uint32_t h2 = prm.seed, h3 = WOPS_SALT;
  pcg4d(h0, h1, h2, h3);
  const float u_alias = to_unit(h0), u_b0 = to_unit(h1), u_b1 = to_unit(h2);
  const int k0 = min((int)(u_pick * (float)prm.n_em), prm.n_em - 1);
  const float2 entry =
      __ldg(reinterpret_cast<const float2*>(tab + (size_t)k0 * WOPS_ROW + EA_WIDTH));
  const int k = u_alias >= entry.x ? (int)entry.y : k0;
  const float* v = tab + (size_t)k * WOPS_ROW;
  auto at3 = [&](int c) { return V3f{v[c], v[c + 1], v[c + 2]}; };
  const bool flip = u_b1 > u_b0;  // core.sampling.square_to_triangle
  const float b1 = flip ? u_b0 * 0.5f : u_b0 - u_b1 * 0.5f;
  const float b2 = flip ? u_b1 - u_b0 * 0.5f : u_b1 * 0.5f;
  return {(at3(EA_V0) + at3(EA_E1) * b1) + at3(EA_E2) * b2, at3(EA_NG), at3(EA_LE),
          v[EA_PDF_AREA], v[EA_TWO_SIDED] > 0.5f};
}

// The shade half of B5 and B6 before their shadow sweeps, for ray i, at the
// regularized material past bounce 0 where prm.path_reg: the NEE sample
// from the staged light set, or with kWops a per-ray draw from the WoPS
// table at lights (clamped by prm.firefly), with kSunNee the sun term, the
// BSDF sample and Russian roulette. The path moves to its next
// vertex without the NEE light and the sun. Returns whether the NEE sample
// is a candidate; then *seg is its shadow segment from *so, the hit moved
// off the surface (tested in (kEpsRay, 1 - 1e-3)), and *rad_lit the path's
// radiance if nothing blocks it. With kSunNee, *sun_cand: whether the
// segment from *so toward the sun is a candidate (tested in (1e-3, 1e8));
// *sun_add what the sun adds to the radiance unless the segment is a
// candidate that something blocks. *trans_out: whether the BSDF sample went
// below the surface. kMat: the BSDF with its transmission and coat lobes,
// as prm.has_trans and prm.has_coat ask.
template <bool kSunNee, bool kWops, bool kMat>
__device__ __forceinline__ bool shade_sample(const float* lights, const BounceParams& prm, int i,
                                             Path& path, const Surface& sf, V3f* so, V3f* seg,
                                             V3f* rad_lit, bool* sun_cand, V3f* sun_add,
                                             bool* trans_out) {
  uint32_t h0 = (uint32_t)prm.pix0 + (uint32_t)i, h1 = (uint32_t)prm.bounce;
  uint32_t h2 = prm.seed, h3 = BOUNCE_SALT;
  pcg4d(h0, h1, h2, h3);
  const float u1 = to_unit(h0), u5 = to_unit(h1), u6 = to_unit(h2), u7 = to_unit(h3);
  const uint32_t lo = (h0 & 0xFFu) | ((h1 & 0xFFu) << 8) | ((h2 & 0xFFu) << 16);
  const float u8 = (float)lo * (1.0f / 16777216.0f);

  Mat mat = sf.mat;
  if (prm.path_reg && prm.bounce >= 1) mat.roughness = regularize(mat.roughness);
  if constexpr (kMat) {
    mat.has_trans = prm.has_trans;
    mat.has_coat = prm.has_coat;
  }
  const Frame frame = make_frame(sf.ns);
  const V3f wo_l = frame.to_local(-path.d);
  *so = sf.pos + sf.ng * kEpsRay;  // the shadow segments start off the surface

  bool candidate = false;
  if (prm.nee && prm.has_lights) {
    LightSample l;
    if constexpr (kWops) {
      l = wops_light(lights, prm, i, u1);
    } else {
      l = set_light(lights, prm, min((int)(u1 * (float)prm.ps), prm.ps - 1));
    }
    const V3f lle = l.le;
    const float lpdf_area = l.pdf_area;
    const V3f to_l = l.p - sf.pos;
    const float dist2 = fmaxf(dot(to_l, to_l), 1e-12f);
    const V3f wi_w = to_l * rsqrtf(dist2);
    const float cos_surf = dot(wi_w, sf.ns);
    const float cos_l_raw = -dot(wi_w, l.ng);
    const float cos_l = l.two_sided ? fabsf(cos_l_raw) : cos_l_raw;
    float pdf_b;
    const V3f f = bsdf_eval<kMat>(mat, wo_l, frame.to_local(wi_w), &pdf_b);
    const float pdf_l_sa2 = lpdf_area * dist2 / fmaxf(cos_l, 1e-8f);
    candidate = path.alive && cos_surf > 1e-6f && cos_l > 1e-6f && lpdf_area > 0.f &&
                prm.bounce >= prm.min_nee_bounce;
    *seg = to_l;  // the segment keeps the length lp - pos
    const float scale = cos_surf * power_heuristic(pdf_l_sa2, pdf_b) / fmaxf(pdf_l_sa2, 1e-12f);
    V3f contrib = path.thr * f * lle * scale;
    if (prm.firefly > 0.f) {
      contrib = {fminf(contrib.x, prm.firefly), fminf(contrib.y, prm.firefly),
                 fminf(contrib.z, prm.firefly)};
    }
    *rad_lit = path.rad + contrib;
  }
  if constexpr (kSunNee) {
    const Sky& s = prm.sky;
    const float cos_s = dot(s.sun, sf.ns);
    float pdf_s;
    const V3f f_s = bsdf_eval<kMat>(mat, wo_l, frame.to_local(s.sun), &pdf_s);
    *sun_cand = path.alive && cos_s > 1e-6f;
    const float gain = *sun_cand ? cos_s : 0.f;
    *sun_add = path.thr * V3f{f_s.x * s.e_sun.x * gain, f_s.y * s.e_sun.y * gain,
                              f_s.z * s.e_sun.z * gain};
  }

  V3f wgt;
  float pdf;
  const V3f wi_l = bsdf_sample<kMat>(mat, wo_l, u5, u6, u7, &wgt, &pdf);
  const V3f wi_w2 = frame.to_world(wi_l);
  const bool transmitted = wi_l.z < 0.f;
  *trans_out = transmitted;
  const float side = dot(wi_w2, sf.ng);
  const bool geo_ok = transmitted ? side < -1e-6f : side > 1e-6f;
  path.alive = path.alive && pdf > 0.f && geo_ok;
  path.thr = path.thr * wgt;
  if (prm.bounce >= prm.rr_start) {
    const float q = clampf(fmaxf(path.thr.x, fmaxf(path.thr.y, path.thr.z)), 0.05f, 0.95f);
    path.alive = path.alive && u8 < q;
    path.thr = path.thr * (1.f / q);
  }
  path.o = sf.pos + sf.ng * (transmitted ? -kEpsRay : kEpsRay);
  path.d = wi_w2;
  path.prev_pdf = pdf;
  path.spec = 0.f;
  return candidate;
}

}  // namespace zr
