// Path bounce kernels: B4 trace, B5 shade, B6 the two fused
// (zetaray_tpu_torch.accel.megakernel.bounce_trace / bounce_shade / bounce).
// They replace the TPU kernels _bounce_trace_kernel, _bounce_shade_kernel
// and _bounce_kernel of the JAX package's accel/megakernel.py.
//
// What bounds them on the card: the Woop arithmetic of their triangle
// sweeps (every ray's closest hit against every real triangle in B4 and B6,
// every NEE shadow segment that nothing blocks against every real triangle
// in B5 and B6), not bytes: a ray's state, surface and light-set entry are
// read once. Without FMAs (--fmad=false, for bit-equality with the plain
// versions) the card reaches at most half its float32 rate, and scattered
// rays diverge in the Woop test's branches.
//
// What the design does about it: all three sweep through sweep.cuh (one ray
// a thread, BOUNCE_BLOCK threads a block, the real triangles only,
// triangle-major rows read as 16-byte broadcasts from a double-buffered
// ring, the sign test before the division, a 64-register cap). During a
// sweep a thread holds only its ray and the running best or its done flag.
// B4 then reads the path state, adds the emission and rebuilds the surface
// (path.cuh surface_at), and writes that surface as the SURF_ROWS rows. B5
// reads that surface back and B6 goes on from its own: both draw the NEE
// sample and the BSDF sample, write the next vertex (path.cuh shade_sample),
// and keep only the shadow segment and the lit radiance for the shadow
// sweep, after which an unblocked ray gets the lit radiance. A warp whose
// segments are all done stops testing; the block leaves when all are.
//
// The tile width rt is a multiple of BOUNCE_BLOCK, so a block's rays share
// one light set, staged in shared memory once (its first LSET_STAGED rows).
// The five uniforms of a bounce come from one pcg4d per ray, computed in
// place. WoPS NEE (kWops, PTConfig.nee_mode="wops") stages nothing: each
// ray draws its light from the emissive alias table in global memory
// (path.cuh wops_light, a second pcg4d), reading the pick's alias entry and
// then its light's row (an 8-byte word and 17 floats of one 128-byte line).
//
// PTConfig.sky and its sun NEE are compile-time branches (kSky: the sky and
// the sun disk on a miss in B4 and B6; kSunNee: a second shadow sweep, of
// unit segments toward the sun in (1e-3, 1e8), in B5 and B6), so the
// instances without them carry none of their code; a sun segment that
// nothing blocks tests every real triangle, as a lit NEE segment does, and
// the sun's term is held in registers across the NEE sweep. WoPS NEE is a
// compile-time branch too (kWops, in B5 and B6), and so are glass and coated
// materials (kMat, in B5 and B6: the transmission and coat lobes of the
// BSDF, taken where the scene has either; which of the two a scene has is
// read at run time, a branch uniform over the launch). Path regularization
// and the firefly clamp are read at run time.
#include "path.cuh"
#include "sweep.cuh"

namespace {

// Ray i of the state rows, or all zeros (it misses every triangle) past n.
__device__ __forceinline__ zr::Ray state_ray(const float* __restrict__ st, int n, int i) {
  auto row = [&](int k) { return st[(size_t)k * n + i]; };
  return i < n ? zr::Ray{row(0), row(1), row(2), row(3), row(4), row(5)}
               : zr::Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
}

// The shadow sweep of B5 and B6 after shade_sample: where ray i's NEE
// segment is a candidate and nothing blocks it, its lit radiance replaces
// rows 9-11 of the state the ray wrote. Every thread of the block must call
// it.
__device__ __forceinline__ void shadow_sweep(zr::SweepRing& ring,
                                             const float4* __restrict__ tri_rows, int nt,
                                             const zr::Ray& seg, bool cand, const zr::V3f& rad_lit,
                                             float* __restrict__ st_out, int n, int i) {
  const bool occ = zr::occluded_sweep(ring, tri_rows, nt, seg, zr::kEpsRay, (float)(1.0 - 1e-3),
                                      !cand);
  if (!cand || occ) return;  // a candidate lies below n
  st_out[(size_t)9 * n + i] = rad_lit.x;
  st_out[(size_t)10 * n + i] = rad_lit.y;
  st_out[(size_t)11 * n + i] = rad_lit.z;
}

// The sun's shadow sweep of B5 and B6 after shade_sample and the NEE sweep:
// ray i (live: below n) adds its sun term `add` to rows 9-11 of the state
// it wrote, unless its segment from `so` toward the sun is a candidate
// that something blocks. Every thread of the block must call it.
__device__ __forceinline__ void sun_sweep(zr::SweepRing& ring, const float4* __restrict__ tri_rows,
                                          int nt, const zr::V3f& so, const zr::V3f& sun,
                                          bool cand, const zr::V3f& add,
                                          float* __restrict__ st_out, int n, int i, bool live) {
  const zr::Ray seg = {so.x, so.y, so.z, sun.x, sun.y, sun.z};
  const bool occ = zr::occluded_sweep(ring, tri_rows, nt, seg, (float)1e-3, (float)1e8, !cand);
  if (!live || (cand && occ)) return;
  float* rad = st_out + (size_t)9 * n + i;
  rad[0] = rad[0] + add.x;
  rad[n] = rad[n] + add.y;
  rad[(size_t)2 * n] = rad[(size_t)2 * n] + add.z;
}

// B4: closest hit, with kSky the sky on a miss, emission and surface
// rebuild. Writes the input state with rows 9-11 (radiance), 13 (alive) and
// 15 (cone width) updated, and the SURF_ROWS surface rows.
template <bool kSky>
__global__ void __launch_bounds__(BOUNCE_BLOCK, zr::kSweepBlocks)
bounce_trace_kernel(const float* __restrict__ st_in, const float4* __restrict__ tri_rows,
                    const float* __restrict__ attrs, float* __restrict__ st_out,
                    float* __restrict__ surf_out, int n, int nt, zr::BounceParams prm,
                    float spread) {
  __shared__ zr::SweepRing ring;
  const int i = blockIdx.x * BOUNCE_BLOCK + threadIdx.x;
  const zr::Hit h = zr::closest_sweep(ring, tri_rows, nt, zr::kTriChunk, state_ray(st_in, n, i),
                                      prm.t_min, ZR_INF);
  if (i >= n) return;

  zr::Path path = zr::load_path(st_in, n, i);
  zr::Surface sf;
  zr::surface_at<kSky>(attrs, prm, h.t, h.tri, h.u, h.v, path, sf);
  path.cone = path.cone + (path.alive ? h.t * spread : 0.f);
  zr::store_path(st_out, n, i, path);  // o, d, throughput, pdf and flag pass through

  const bool hit = h.tri >= 0;
  const float* row = attrs + (size_t)(hit ? h.tri : 0) * A_WIDTH;
  auto at = [&](int k) { return hit ? row[k] : 0.f; };
  const float w0 = 1.f - h.u - h.v;
  const float s[SURF_ROWS] = {
      sf.pos.x, sf.pos.y, sf.pos.z, sf.ns.x, sf.ns.y, sf.ns.z, sf.ng.x, sf.ng.y, sf.ng.z,
      sf.mat.base.x, sf.mat.base.y, sf.mat.base.z, sf.mat.metallic, sf.mat.roughness,
      sf.mat.ior, at(A_TRANS), sf.eta, at(A_COATW), at(A_COATR),
      w0 * at(A_UV0) + h.u * at(A_UV1) + h.v * at(A_UV2),
      w0 * at(A_UV0 + 1) + h.u * at(A_UV1 + 1) + h.v * at(A_UV2 + 1),
      hit ? at(A_TEXID) : -1.f, at(A_UVDENS), 0.f};
#pragma unroll
  for (int r = 0; r < SURF_ROWS; ++r) surf_out[(size_t)r * n + i] = s[r];
}

// B5: NEE (with kWops from the WoPS table at sets), with kSunNee the sun's
// term, BSDF sample (with kMat the transmission and coat lobes, from surface
// rows 15-18) and Russian roulette from the surface rows of B4, then the
// shadow sweeps. Writes the next vertex, with the cone width scaled by eta
// where the sample was transmitted.
template <bool kSunNee, bool kWops, bool kMat>
__global__ void __launch_bounds__(BOUNCE_BLOCK, zr::kSweepBlocks)
bounce_shade_kernel(const float* __restrict__ st_in, const float* __restrict__ surf,
                    const float4* __restrict__ tri_rows, const float* __restrict__ sets,
                    float* __restrict__ st_out, int n, int nt, zr::BounceParams prm) {
  __shared__ zr::SweepRing ring;
  extern __shared__ float lset[];  // [LSET_STAGED][ps]; empty with kWops
  const int p0 = blockIdx.x * BOUNCE_BLOCK;
  const int i = p0 + threadIdx.x;
  const bool nee = prm.nee && prm.has_lights;
  if (!kWops && nee) zr::stage_light_set(lset, sets, zr::bounce_set(prm, p0), prm.ps);
  __syncthreads();

  zr::Ray seg = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  zr::V3f rad_lit, sun_add;
  bool cand = false, sun_cand = false;
  if (i < n) {
    zr::Path path = zr::load_path(st_in, n, i);
    auto s = [&](int r) { return surf[(size_t)r * n + i]; };
    zr::Surface sf;
    sf.pos = {s(0), s(1), s(2)};
    sf.ns = {s(3), s(4), s(5)};
    sf.ng = {s(6), s(7), s(8)};
    sf.mat = {{s(9), s(10), s(11)}, s(12), s(13), s(14)};
    sf.eta = s(16);
    if constexpr (kMat) {
      sf.mat.trans = s(15);
      sf.mat.eta = sf.eta;
      sf.mat.coat = s(17);
      sf.mat.coat_rough = s(18);
    }
    zr::V3f so, to_l;
    bool transmitted;
    cand = zr::shade_sample<kSunNee, kWops, kMat>(kWops ? sets : lset, prm, i, path, sf, &so,
                                                  &to_l, &rad_lit, &sun_cand, &sun_add,
                                                  &transmitted);
    seg = {so.x, so.y, so.z, to_l.x, to_l.y, to_l.z};
    if (transmitted && sf.eta > 0.f) path.cone = path.cone * sf.eta;
    zr::store_path(st_out, n, i, path);
  }
  if (nee) shadow_sweep(ring, tri_rows, nt, seg, cand, rad_lit, st_out, n, i);
  if constexpr (kSunNee) {
    sun_sweep(ring, tri_rows, nt, {seg.ox, seg.oy, seg.oz}, prm.sky.sun, sun_cand, sun_add,
              st_out, n, i, i < n);
  }
}

// B6: one whole bounce; with last != 0 only the trace half, its sky and its
// emission. kWops, kMat: as for B5.
template <bool kSky, bool kSunNee, bool kWops, bool kMat>
__global__ void __launch_bounds__(BOUNCE_BLOCK, zr::kSweepBlocks)
bounce_kernel(const float* __restrict__ st_in, const float4* __restrict__ tri_rows,
              const float* __restrict__ attrs, const float* __restrict__ sets,
              float* __restrict__ st_out, int n, int nt, zr::BounceParams prm, int last) {
  __shared__ zr::SweepRing ring;
  extern __shared__ float lset[];  // [LSET_STAGED][ps]; empty with kWops
  const int p0 = blockIdx.x * BOUNCE_BLOCK;
  const int i = p0 + threadIdx.x;
  const bool live = i < n;
  const bool nee = !last && prm.nee && prm.has_lights;
  if (!kWops && nee) zr::stage_light_set(lset, sets, zr::bounce_set(prm, p0), prm.ps);
  __syncthreads();

  const zr::Hit hit = zr::closest_sweep(ring, tri_rows, nt, zr::kTriChunk, state_ray(st_in, n, i),
                                        prm.t_min, ZR_INF);

  // what the shadow sweeps need: the segment, whether it is a candidate, and
  // the radiance with the NEE light; the sun's candidacy and term
  zr::Ray seg = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  zr::V3f rad_lit, sun_add;
  bool cand = false, sun_cand = false;
  if (live) {
    zr::Path path = zr::load_path(st_in, n, i);
    zr::Surface sf;
    zr::surface_at<kSky, kMat>(attrs, prm, hit.t, hit.tri, hit.u, hit.v, path, sf);
    if (!last) {
      zr::V3f so, to_l;
      bool transmitted;  // B6 keeps its cone width, as its plain version does
      cand = zr::shade_sample<kSunNee, kWops, kMat>(kWops ? sets : lset, prm, i, path, sf, &so,
                                                    &to_l, &rad_lit, &sun_cand, &sun_add,
                                                    &transmitted);
      seg = {so.x, so.y, so.z, to_l.x, to_l.y, to_l.z};
    }
    zr::store_path(st_out, n, i, path);
  }
  if (nee) shadow_sweep(ring, tri_rows, nt, seg, cand, rad_lit, st_out, n, i);
  if constexpr (kSunNee) {
    if (!last) {
      sun_sweep(ring, tri_rows, nt, {seg.ox, seg.oy, seg.oz}, prm.sky.sun, sun_cand, sun_add,
                st_out, n, i, live);
    }
  }
}

zr::BounceParams params(int bounce, uint32_t seed, int rt, int pix0, int n_sets, int ps,
                        int n_em, float t_min, int min_emissive_bounce, int min_nee_bounce,
                        int rr_start, int nee, int has_lights, int mat, const float* opts) {
  zr::BounceParams p;
  p.bounce = bounce;
  p.seed = seed;
  p.rt = rt;
  p.pix0 = pix0;
  p.tile0 = pix0 / rt;
  p.n_sets = n_sets;
  p.ps = ps;
  p.n_em = n_em;
  p.t_min = t_min;
  p.min_emissive_bounce = min_emissive_bounce;
  p.min_nee_bounce = min_nee_bounce;
  p.rr_start = rr_start;
  p.nee = nee != 0;
  p.has_lights = has_lights != 0;
  p.has_trans = (mat & 1) != 0;
  p.has_coat = (mat & 2) != 0;
  zr::set_path_options(p, opts);
  return p;
}

// The instance of a kernel template <..., kMat> for the material flags mat.
template <class K>
K pick_mat(int mat, K opaque, K with_mat) {
  return mat != 0 ? with_mat : opaque;
}

}  // namespace

// tri_rows: the triangle-major Woop rows [tp][12] (SceneBuffers.woop_rows());
// nt: the real triangles, the first nt slots; opts: the path options, a
// host array of PATH_OPTS floats (accel.megakernel.path_options) or null.
extern "C" int zr_bounce_trace(const float* st_in, const float* tri_rows, const float* attrs,
                               float* st_out, float* surf_out, int n, int tp, int nt,
                               int bounce, float t_min, float spread, int min_emissive_bounce,
                               int nee, int has_lights, const float* opts, void* stream) {
  if (nt < 0 || nt > tp || !(t_min >= 0.f)) return (int)cudaErrorInvalidValue;
  const zr::BounceParams p = params(bounce, 0u, BOUNCE_BLOCK, 0, 1, 1, 0, t_min,
                                    min_emissive_bounce, 0, 0, nee, has_lights, 0, opts);
  const int grid = (n + BOUNCE_BLOCK - 1) / BOUNCE_BLOCK;
  const auto kernel = zr::opts_sky(opts) ? bounce_trace_kernel<true> : bounce_trace_kernel<false>;
  if (grid > 0) {
    kernel<<<grid, BOUNCE_BLOCK, 0, (cudaStream_t)stream>>>(
        st_in, reinterpret_cast<const float4*>(tri_rows), attrs, st_out, surf_out, n, nt, p,
        spread);
  }
  return (int)cudaGetLastError();
}

// tri_rows, nt, opts: as for zr_bounce_trace. wops_em: 0 for NEE from the
// light sets at sets ([n_sets][LSET_ROWS][ps]); > 0 for WoPS NEE over that
// many emissives, sets then the [ps][WOPS_ROW] table (wops_table, ps its
// padded emissive count). mat: the scene's material lobes, bit 0
// transmission, bit 1 coat (material_flags); 0 takes the opaque instances.
// pix0: the global id of ray 0 (a row band's offset; 0 for the whole image):
// ray i draws from the tile pix0 / rt + i / rt and the random stream pix0 + i.
extern "C" int zr_bounce_shade(const float* st_in, const float* surf, const float* tri_rows,
                               const float* sets, float* st_out, int n, int tp, int nt,
                               int n_sets, int ps, int rt, int pix0, int bounce, uint32_t seed,
                               int min_nee_bounce, int rr_start, int nee, int has_lights,
                               int wops_em, int mat, const float* opts, void* stream) {
  if (nt < 0 || nt > tp || rt % BOUNCE_BLOCK || pix0 < 0 || wops_em < 0 || wops_em > ps ||
      mat < 0 || mat > 3) {
    return (int)cudaErrorInvalidValue;
  }
  const zr::BounceParams p = params(bounce, seed, rt, pix0, n_sets, ps, wops_em, 0.f, 0,
                                    min_nee_bounce, rr_start, nee, has_lights, mat, opts);
  const int grid = (n + BOUNCE_BLOCK - 1) / BOUNCE_BLOCK;
  const bool wops = wops_em > 0;
  const size_t smem = wops ? 0 : (size_t)LSET_STAGED * ps * sizeof(float);
  const bool sun = zr::opts_sun_nee(opts);
  const auto kernel =
      wops ? (sun ? pick_mat(mat, bounce_shade_kernel<true, true, false>,
                             bounce_shade_kernel<true, true, true>)
                  : pick_mat(mat, bounce_shade_kernel<false, true, false>,
                             bounce_shade_kernel<false, true, true>))
           : (sun ? pick_mat(mat, bounce_shade_kernel<true, false, false>,
                             bounce_shade_kernel<true, false, true>)
                  : pick_mat(mat, bounce_shade_kernel<false, false, false>,
                             bounce_shade_kernel<false, false, true>));
  if (grid > 0) {
    kernel<<<grid, BOUNCE_BLOCK, smem, (cudaStream_t)stream>>>(
        st_in, surf, reinterpret_cast<const float4*>(tri_rows), sets, st_out, n, nt, p);
  }
  return (int)cudaGetLastError();
}

// tri_rows, nt, opts: as for zr_bounce_trace; sets, pix0, wops_em, mat: as
// for zr_bounce_shade.
extern "C" int zr_bounce(const float* st_in, const float* tri_rows, const float* attrs,
                         const float* sets, float* st_out, int n, int tp, int nt, int n_sets,
                         int ps, int rt, int pix0, int bounce, uint32_t seed, float t_min,
                         int min_emissive_bounce, int min_nee_bounce, int rr_start, int nee,
                         int has_lights, int last, int wops_em, int mat, const float* opts,
                         void* stream) {
  if (nt < 0 || nt > tp || rt % BOUNCE_BLOCK || pix0 < 0 || !(t_min >= 0.f) || wops_em < 0 ||
      wops_em > ps || mat < 0 || mat > 3) {
    return (int)cudaErrorInvalidValue;
  }
  const zr::BounceParams p = params(bounce, seed, rt, pix0, n_sets, ps, wops_em, t_min,
                                    min_emissive_bounce, min_nee_bounce, rr_start, nee,
                                    has_lights, mat, opts);
  const int grid = (n + BOUNCE_BLOCK - 1) / BOUNCE_BLOCK;
  const bool wops = wops_em > 0;
  const size_t smem = wops ? 0 : (size_t)LSET_STAGED * ps * sizeof(float);
  const bool sky = zr::opts_sky(opts), sun = zr::opts_sun_nee(opts);
  const auto kernel =
      wops ? (!sky ? pick_mat(mat, bounce_kernel<false, false, true, false>,
                              bounce_kernel<false, false, true, true>)
              : sun ? pick_mat(mat, bounce_kernel<true, true, true, false>,
                               bounce_kernel<true, true, true, true>)
                    : pick_mat(mat, bounce_kernel<true, false, true, false>,
                               bounce_kernel<true, false, true, true>))
           : (!sky ? pick_mat(mat, bounce_kernel<false, false, false, false>,
                              bounce_kernel<false, false, false, true>)
              : sun ? pick_mat(mat, bounce_kernel<true, true, false, false>,
                               bounce_kernel<true, true, false, true>)
                    : pick_mat(mat, bounce_kernel<true, false, false, false>,
                               bounce_kernel<true, false, false, true>));
  if (grid > 0) {
    kernel<<<grid, BOUNCE_BLOCK, smem, (cudaStream_t)stream>>>(
        st_in, reinterpret_cast<const float4*>(tri_rows), attrs, sets, st_out, n, nt, p, last);
  }
  return (int)cudaGetLastError();
}
