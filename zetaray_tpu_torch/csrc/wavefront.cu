// The wavefront path trace's vertex kernel (zetaray_tpu_torch.ops.pathtracer
// trace_reference on a clustered scene): what one bounce of the plain
// wavefront does between its closest-hit query (B8) and its NEE shadow
// query (B9), for one ray a thread. A bounce is B8, this kernel and, where
// NEE runs, B9; B8 and B9 stay launches of their own kernels.
//
// Replaces no TPU kernel: the JAX wavefront (zetaray_tpu/ops/pathtracer.py
// trace_reference) is XLA-side. It was added because the plain wavefront
// dispatched some 1,200 PyTorch operators a bounce (about 5,800 a frame of
// the default restir_di frame at max_bounces = 4), each a launch over
// [N] float rows: the host's enqueue of them paced the frame.
//
// Per ray and bounce, in the plain wavefront's order: the winner's
// Moller-Trumbore (t, u, v) against v0/e1/e2 (accel/stream.py _mt_tuv),
// the attribute columns the vertex reads, straight from tri_attrs[tri]
// (no [48, N] gather; at bounce 0 the whole row is written out where the
// caller asks for the first hit), the shading normal and the front/back
// flip, the material (accel.megakernel.hit_material; kMat: the
// transmission and coat lobes), the NEE of the previous bounce where B9
// found its segment free, MIS-weighted emission gated by
// min_emissive_bounce, NEE gated by min_nee_bounce (ops/lights.py
// sample_emissive's alias pick and point, bsdf_eval, and the segment parked
// for B9), the BSDF sample, the geometric side test, the stochastic
// multi-bounce kill at bounce 0, Russian roulette from rr_start, and the
// next ray, parked where the path ended, as B8's input.
//
// Bound: bytes. A ray reads its B8 slot, o and d, its path state
// (WF_ROWS floats), the v0/e1/e2 rows and about 24 attribute columns of its
// hit, and where NEE runs one alias entry and one 17-float emissive row; it
// writes the state, its radiance, the next ray and the shadow segment: about
// 0.4 KB a ray at most, some 0.8 GB a bounce at 1920x1080 (0.25 ms at
// 3.35 TB/s). Its float work, two BSDF evaluations with their GGX albedo
// fits (~600 operations), is of the same order at the card's float32 rate
// without FMAs. The design keeps the whole vertex in registers and every
// path row SoA (one coalesced word a thread a row); the rows a hit reads
// are random, as the hits are.
//
// Float result: the plain wavefront's on the card, bit for bit. Each
// operation rounds on its own (--fmad=false) in the plain code's
// association; a tensor divided by a tensor is an IEEE division, 1 / x is
// PyTorch's reciprocal (IEEE), torch.rsqrt is rsqrtf, clamp_min and
// maximum pass NaN through; the BSDF, its sample and the power heuristic
// are path.cuh's, which B5 and B6 hold to ops/shading_soa.py. The random
// numbers are core.rng.uniform4(pix0 + i, bounce, seed, salt) with salt 1
// (the light), 2 (the BSDF sample) and 3 (Russian roulette).
//
// Path state rows (WF_ROWS, [WF_ROWS, n]): 0-2 throughput | 3 the BSDF
// pdf of the last sample | 4 alive | 5-7 the NEE contribution waiting for
// B9 | 8 whether its segment is a candidate. Bounce 0 reads no state.
#include "path.cuh"

namespace {

constexpr int kBlock = 128;
constexpr float kPark = 3.0e7f;  // ops/pathtracer.py _PARK

// torch.clamp_min / clamp_max / maximum against a float: NaN passes through
__device__ __forceinline__ float t_clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float t_clamp_max(float v, float hi) { return v != v ? v : fminf(v, hi); }
__device__ __forceinline__ float t_maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// The four uniforms of core.rng.uniform4(pixel, bounce, seed, salt).
__device__ __forceinline__ void uniform4(uint32_t pixel, int bounce, uint32_t seed, uint32_t salt,
                                         float u[4]) {
  uint32_t a = pixel, b = (uint32_t)bounce, c = seed, d = salt;
  zr::pcg4d(a, b, c, d);
  u[0] = zr::to_unit(a);
  u[1] = zr::to_unit(b);
  u[2] = zr::to_unit(c);
  u[3] = zr::to_unit(d);
}

__device__ __forceinline__ zr::V3f load3(const float* p, int i) {
  return {p[(size_t)3 * i], p[(size_t)3 * i + 1], p[(size_t)3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, int i, zr::V3f v) {
  p[(size_t)3 * i] = v.x;
  p[(size_t)3 * i + 1] = v.y;
  p[(size_t)3 * i + 2] = v.z;
}

struct VertexParams {
  int n, bounce, pix0, n_em, min_emissive_bounce, min_nee_bounce, rr_start;
  uint32_t seed;
  float firefly;  // 0: off; else the most a NEE sample adds
  bool nee, has_lights, last, path_reg, has_trans, has_coat;
};

// o, d, o_next, d_next, rad, seg_o, seg_d: [n, 3]; o_next/d_next may be o/d
// (each thread reads its ray before it writes the next). occluded: B9's
// answer for the previous bounce's segments, null where that bounce ran no
// NEE. smb_kill: null for none. hit_t/u/v [n] and hit_attrs [A_WIDTH, n]:
// the first hit, written at bounce 0 where hit_t is not null.
template <bool kMat>
__global__ void __launch_bounds__(kBlock)
wavefront_vertex_kernel(const float* o_in, const float* d_in, const int* __restrict__ tri,
                        const uint8_t* __restrict__ occluded, const uint8_t* __restrict__ smb_kill,
                        const float* __restrict__ v0s, const float* __restrict__ e1s,
                        const float* __restrict__ e2s, const float* __restrict__ attrs,
                        const float* __restrict__ em_prob, const int* __restrict__ em_alias,
                        const float* __restrict__ em_attrs, float* __restrict__ st,
                        float* __restrict__ rad_out, float* o_next, float* d_next,
                        float* __restrict__ seg_o, float* __restrict__ seg_d,
                        float* __restrict__ hit_t, float* __restrict__ hit_u,
                        float* __restrict__ hit_v, float* __restrict__ hit_attrs,
                        VertexParams p) {
  using zr::V3f;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n) return;
  const int n = p.n;
  auto row = [&](int k) -> float& { return st[(size_t)k * n + i]; };

  V3f thr{1.f, 1.f, 1.f}, rad{0.f, 0.f, 0.f};
  float prev_pdf = 0.f;
  bool alive = true;
  if (p.bounce > 0) {
    thr = {row(0), row(1), row(2)};
    prev_pdf = row(3);
    alive = row(4) > 0.5f;
    rad = load3(rad_out, i);
  }
  if (occluded != nullptr) {  // the previous bounce's NEE, where nothing blocks it
    const bool vis = row(8) > 0.5f && occluded[i] == 0;
    rad = rad + V3f{vis ? row(5) : 0.f, vis ? row(6) : 0.f, vis ? row(7) : 0.f};
  }

  // the closest hit's Moller-Trumbore (t, u, v) (accel/stream.py _mt_tuv)
  const int slot = tri[i];
  const bool hit = slot >= 0;
  const int idx = hit ? slot : 0;
  const V3f o = load3(o_in, i), d = load3(d_in, i);
  const V3f v0 = load3(v0s, idx), e1 = load3(e1s, idx), e2 = load3(e2s, idx);
  const V3f pvec = zr::cross(d, e2);
  const float det = zr::dot(e1, pvec);
  const float inv = 1.f / (fabsf(det) < 1e-20f ? 1e-20f : det);
  const V3f tvec = o - v0;
  const float u_mt = zr::dot(tvec, pvec) * inv;
  const V3f qvec = zr::cross(tvec, e1);
  const float v_mt = zr::dot(d, qvec) * inv;
  const float t_mt = zr::dot(e2, qvec) * inv;
  const float t = hit ? t_mt : ZR_INF, u = hit ? u_mt : 0.f, v = hit ? v_mt : 0.f;

  const float* at_row = attrs + (size_t)idx * A_WIDTH;
  auto at = [&](int k) { return hit ? at_row[k] : 0.f; };
  auto at3 = [&](int k) { return V3f{at(k), at(k + 1), at(k + 2)}; };
  if (hit_t != nullptr) {
    hit_t[i] = t;
    hit_u[i] = u;
    hit_v[i] = v;
    for (int k = 0; k < A_WIDTH; ++k) hit_attrs[(size_t)k * n + i] = at(k);
  }
  const bool found = hit && alive;

  // the hit's surface
  const float w0 = (1.f - u) - v;
  const V3f ng_raw = at3(A_NG);
  V3f ns = (at3(A_N0) * w0 + at3(A_N1) * u) + at3(A_N2) * v;
  const float len = t_clamp_min(sqrtf(zr::dot(ns, ns)), 1e-20f);
  ns = {ns.x / len, ns.y / len, ns.z / len};
  const bool front = zr::dot(d, ng_raw) < 0.f;
  const float sgn = front ? 1.f : -1.f;
  const V3f ng = ng_raw * sgn;
  ns = ns * sgn;
  if (zr::dot(ns, ng) < 0.f) ns = -ns;
  const V3f pos = o + d * t;
  zr::Mat mat;
  const float ior = t_clamp_min(at(A_IOR), 1.01f);
  mat.base = at3(A_BASE);
  mat.metallic = at(A_METAL);
  mat.roughness = at(A_ROUGH);
  mat.ior = ior;
  mat.trans = at(A_TRANS);
  mat.eta = front ? 1.f / ior : ior;
  mat.coat = at(A_COATW);
  mat.coat_rough = at(A_COATR);
  mat.has_trans = p.has_trans;
  mat.has_coat = p.has_coat;
  if (p.path_reg && p.bounce > 0) mat.roughness = zr::regularize(mat.roughness);

  // emitted radiance at the hit, MIS-weighted against the previous NEE
  if (p.has_lights && p.bounce >= p.min_emissive_bounce) {
    const float wo_dot_ng = -zr::dot(d, ng_raw);
    const bool visible = at(A_DOUBLE) > 0.5f || wo_dot_ng > 0.f;
    const V3f le = visible ? at3(A_EMISS) : V3f{0.f, 0.f, 0.f};
    float mis = 1.f;
    if (p.nee && p.bounce > 0) {  // past bounce 0 no ray is specular
      const float pdf_l_sa = at(A_EM_PDF_AREA) * (t * t) / t_clamp_min(fabsf(wo_dot_ng), 1e-8f);
      mis = zr::power_heuristic(prev_pdf, pdf_l_sa);
    }
    const V3f add = (thr * le) * mis;
    rad = rad + V3f{found ? add.x : 0.f, found ? add.y : 0.f, found ? add.z : 0.f};
  }
  alive = found;
  if (p.last) {
    store3(rad_out, i, rad);
    return;
  }

  const zr::Frame frame = zr::make_frame(ns);
  const V3f wo_l = frame.to_local(-d);
  const uint32_t pixel = (uint32_t)p.pix0 + (uint32_t)i;
  float uw[4];

  // NEE: one shadow segment toward a point on an emissive triangle
  if (p.nee && p.has_lights && p.bounce >= p.min_nee_bounce) {
    uniform4(pixel, p.bounce, p.seed, 1u, uw);
    const int k0 = min((int)(uw[0] * (float)p.n_em), p.n_em - 1);  // core.sampling.sample_alias
    const int k = uw[1] >= em_prob[k0] ? em_alias[k0] : k0;
    const float* lr = em_attrs + (size_t)k * EA_WIDTH;
    auto l3 = [&](int c) { return V3f{lr[c], lr[c + 1], lr[c + 2]}; };
    const bool flip = uw[3] > uw[2];  // core.sampling.square_to_triangle
    const float b1 = flip ? uw[2] * 0.5f : uw[2] - uw[3] * 0.5f;
    const float b2 = flip ? uw[3] - uw[2] * 0.5f : uw[3] * 0.5f;
    const V3f lpos = (l3(EA_V0) + l3(EA_E1) * b1) + l3(EA_E2) * b2;
    const V3f to_l = lpos - pos;
    const float dist2 = t_clamp_min(zr::dot(to_l, to_l), 1e-12f);
    const V3f wi_w = to_l * rsqrtf(dist2);
    const float cos_surf = zr::dot(wi_w, ns);
    const float cos_l_raw = -zr::dot(wi_w, l3(EA_NG));
    const float cos_l = lr[EA_TWO_SIDED] > 0.5f ? fabsf(cos_l_raw) : cos_l_raw;
    float pdf_b;
    const V3f f = zr::bsdf_eval<kMat>(mat, wo_l, frame.to_local(wi_w), &pdf_b);
    const float pdf_l_sa = lr[EA_PDF_AREA] * dist2 / t_clamp_min(cos_l, 1e-8f);
    const bool cand = alive && cos_surf > 1e-6f && cos_l > 1e-6f;
    // the unnormalised segment as direction: the light sits at t = 1
    store3(seg_o, i, cand ? pos + ng * zr::kEpsRay : V3f{kPark, kPark, kPark});
    store3(seg_d, i, cand ? to_l : V3f{1.f, 0.f, 0.f});
    const float mis = zr::power_heuristic(pdf_l_sa, pdf_b);
    V3f c = ((thr * f) * l3(EA_LE)) * (cos_surf * mis / t_clamp_min(pdf_l_sa, 1e-12f));
    if (p.firefly > 0.f) {
      c = {t_clamp_max(c.x, p.firefly), t_clamp_max(c.y, p.firefly), t_clamp_max(c.z, p.firefly)};
    }
    row(5) = c.x;
    row(6) = c.y;
    row(7) = c.z;
    row(8) = cand ? 1.f : 0.f;
  }

  // BSDF sample of the next direction
  uniform4(pixel, p.bounce, p.seed, 2u, uw);
  V3f weight;
  float pdf;
  const V3f wi_l = zr::bsdf_sample<kMat>(mat, wo_l, uw[0], uw[1], uw[2], &weight, &pdf);
  const V3f wi_w = frame.to_world(wi_l);
  // reflected rays leave above the geometric surface, transmitted below
  const bool transmitted = wi_l.z < 0.f;
  const float side = zr::dot(wi_w, ng);
  const bool geo_ok = transmitted ? side < -1e-6f : side > 1e-6f;
  alive = alive && pdf > 0.f && geo_ok;
  thr = thr * weight;
  if (smb_kill != nullptr && p.bounce == 0) alive = alive && smb_kill[i] == 0;
  if (p.bounce >= p.rr_start) {
    uniform4(pixel, p.bounce, p.seed, 3u, uw);
    const float mx = t_maximum(thr.x, t_maximum(thr.y, thr.z));
    const float q = t_clamp_max(t_clamp_min(mx, 0.05f), 0.95f);
    alive = alive && uw[0] < q;
    thr = {thr.x / q, thr.y / q, thr.z / q};
  }
  const float offset = transmitted ? -1.f : 1.f;
  const V3f o2 = pos + (ng * zr::kEpsRay) * offset;
  store3(o_next, i, alive ? o2 : V3f{kPark, kPark, kPark});
  store3(d_next, i, alive ? wi_w : V3f{1.f, 0.f, 0.f});
  row(0) = thr.x;
  row(1) = thr.y;
  row(2) = thr.z;
  row(3) = pdf;
  row(4) = alive ? 1.f : 0.f;
  store3(rad_out, i, rad);
}

}  // namespace

// One vertex of the wavefront for rays o, d [n, 3] after their closest
// hit (B8's slots tri [n]); see the kernel. The scene's tables: v0/e1/e2
// [T, 3], tri_attrs [T, A_WIDTH], and where has_lights the alias table
// em_prob/em_alias over n_em emissives and em_attrs [., EA_WIDTH]. mat: the
// material lobes, bit 0 transmission, bit 1 coat (material_flags); 0 takes
// the opaque instance. pix0: the global id of ray 0; ray i's random
// streams are those of pix0 + i.
extern "C" int zr_wavefront_vertex(const float* o, const float* d, const int* tri,
                                   const uint8_t* occluded, const uint8_t* smb_kill,
                                   const float* v0, const float* e1, const float* e2,
                                   const float* attrs, const float* em_prob, const int* em_alias,
                                   const float* em_attrs, float* state, float* rad,
                                   float* o_next, float* d_next, float* seg_o, float* seg_d,
                                   float* hit_t, float* hit_u, float* hit_v, float* hit_attrs,
                                   int n, int bounce, int pix0, uint32_t seed, int n_em,
                                   int min_emissive_bounce, int min_nee_bounce, int rr_start,
                                   int nee, int has_lights, int last, int path_reg, int mat,
                                   float firefly, void* stream) {
  if (n < 0 || bounce < 0 || pix0 < 0 || mat < 0 || mat > 3 || (has_lights && n_em <= 0) ||
      (bounce > 0 && hit_t != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  VertexParams p;
  p.n = n;
  p.bounce = bounce;
  p.pix0 = pix0;
  p.n_em = n_em;
  p.min_emissive_bounce = min_emissive_bounce;
  p.min_nee_bounce = min_nee_bounce;
  p.rr_start = rr_start;
  p.seed = seed;
  p.firefly = firefly;
  p.nee = nee != 0;
  p.has_lights = has_lights != 0;
  p.last = last != 0;
  p.path_reg = path_reg != 0;
  p.has_trans = (mat & 1) != 0;
  p.has_coat = (mat & 2) != 0;
  const int grid = (n + kBlock - 1) / kBlock;
  const auto kernel = mat != 0 ? wavefront_vertex_kernel<true> : wavefront_vertex_kernel<false>;
  if (grid > 0) {
    kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        o, d, tri, occluded, smb_kill, v0, e1, e2, attrs, em_prob, em_alias, em_attrs, state, rad,
        o_next, d_next, seg_o, seg_d, hit_t, hit_u, hit_v, hit_attrs, p);
  }
  return (int)cudaGetLastError();
}
