// Closest hit (kernel B8) and any hit (kernel B9) on a clustered scene.
//
// Replace _closest_stream_kernel and _occlusion_stream_kernel of the JAX
// package (accel/stream.py). Those swept tiles of shaft-sorted rays over a
// per-tile visit list of clusters; here each thread walks the tree over the
// cluster boxes (accel/bvh.py cluster_tree) for its own ray with a stack of
// TREE_STACK nodes, nearer child first, and runs the Woop test of
// common.cuh over the C slots of each cluster it reaches, reading the woop
// [4, 3, tp] table in place. The least work is the Woop arithmetic of the
// clusters a ray must reach (about 40 float operations per ray-triangle
// test); this first version runs far above it (PERF.md): each test is a
// chain of dependent L1/L2 loads in one thread, and the threads of a warp
// walk different clusters.
//
// B8 keeps the tie rule of its plain version (tie groups of one cluster)
// whatever order the walk takes: the best hit is the lexicographic least of
// (t, cluster, -slot), and a node is culled only when its entry lies
// strictly beyond the best t. The slab test never culls a true hit: the
// node boxes are padded at build, the kernel pads them again by
// TREE_PAD_REL of the ray origin's largest coordinate (the Woop test rounds
// a hit point off its triangle by a few ulps of the coordinates involved)
// and widens the slab interval by a relative kWiden. A ray with a
// non-finite coordinate misses in the Woop test, culled or not; a NaN entry
// visits. A ray whose origin is near the float range (a missed primary
// ray's far end) is padded by as much and walks most clusters. B9 stops at
// the ray's first hit.
#include "common.cuh"
#include "layout.h"  // TREE_STACK, TREE_PAD_REL

namespace {

constexpr float kWiden = 1e-6f;  // relative slack of the slab interval (PBRT's 2*gamma_3 is 3.6e-7)

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ivx, ivy, ivz;  // 1 / d, with |d| < 1e-20 taken as 1e-20
  float pad;            // TREE_PAD_REL * the origin's largest coordinate
  float t_min;
};

__device__ __forceinline__ float safe_inv(float x) {
  return 1.0f / (fabsf(x) < 1e-20f ? 1e-20f : x);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        int i, float t_min) {
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.ivx = safe_inv(r.dx); r.ivy = safe_inv(r.dy); r.ivz = safe_inv(r.dz);
  r.pad = TREE_PAD_REL * fmaxf(fabsf(r.ox), fmaxf(fabsf(r.oy), fabsf(r.oz)));
  r.t_min = t_min;
  return r;
}

// The ray's entry t into node k's box, in *t_near. Returns false (cull) when
// the widened slab interval is empty, ends before t_min or starts strictly
// beyond t_hi.
__device__ __forceinline__ bool node_entry(const float* __restrict__ lo,
                                           const float* __restrict__ hi, int k, const Ray& r,
                                           float t_hi, float* t_near) {
  const float* l = lo + 3 * k;
  const float* h = hi + 3 * k;
  const float x0 = (l[0] - r.pad - r.ox) * r.ivx, x1 = (h[0] + r.pad - r.ox) * r.ivx;
  const float y0 = (l[1] - r.pad - r.oy) * r.ivy, y1 = (h[1] + r.pad - r.oy) * r.ivy;
  const float z0 = (l[2] - r.pad - r.oz) * r.ivz, z1 = (h[2] + r.pad - r.oz) * r.ivz;
  float tn = fmaxf(fminf(x0, x1), fmaxf(fminf(y0, y1), fminf(z0, z1)));
  float tf = fminf(fmaxf(x0, x1), fminf(fmaxf(y0, y1), fmaxf(z0, z1)));
  // scaled, not shifted: an entry at +inf (a ray that never reaches the
  // slab of an axis it barely moves along) stays +inf, where inf - inf
  // would make a NaN that visits every cluster
  tn = tn * (tn > 0.0f ? 1.0f - kWiden : 1.0f + kWiden);
  tf = tf * (tf > 0.0f ? 1.0f + kWiden : 1.0f - kWiden);
  tn = tn > r.t_min ? tn : r.t_min;
  *t_near = tn;
  return !((tf < tn) || (tn > t_hi));
}

struct Tree {
  const float* lo;
  const float* hi;
  const int32_t* left;
  const int32_t* right;
  const int32_t* cluster;
};

__global__ void stream_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                      const float* __restrict__ woop, Tree tree,
                                      float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                                      int n, int tp, int c, float t_min, float t_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i, t_min);
  float best_t = ZR_INF;
  int best_tri = -1, best_c = 0x7fffffff;
  int stack_node[TREE_STACK];
  float stack_t[TREE_STACK];
  int sp = 0;
  float tn;
  if (node_entry(tree.lo, tree.hi, 0, r, t_max, &tn)) {
    stack_node[0] = 0;
    stack_t[0] = tn;
    sp = 1;
  }
  while (sp > 0) {
    --sp;
    const int k = stack_node[sp];
    if (stack_t[sp] > best_t) continue;  // an equal t in a lower cluster still counts
    const int cl = tree.cluster[k];
    if (cl >= 0) {
      // the cluster's slots: the highest slot among equal t
      float ct = ZR_INF;
      int cj = -1;
      for (int j = cl * c; j < (cl + 1) * c; ++j) {
        float u, v;
        const float t = zr::woop_test(woop, tp, j, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t_min,
                                      t_max, &u, &v);
        if (t < ZR_INF && t <= ct) {
          ct = t;
          cj = j;
        }
      }
      if (cj >= 0 && (ct < best_t || (ct == best_t && cl < best_c))) {
        best_t = ct;
        best_tri = cj;
        best_c = cl;
      }
      continue;
    }
    const float t_hi = fminf(best_t, t_max);
    const int a = tree.left[k], b = tree.right[k];
    float ta, tb;
    const bool oka = node_entry(tree.lo, tree.hi, a, r, t_hi, &ta);
    const bool okb = node_entry(tree.lo, tree.hi, b, r, t_hi, &tb);
    // the farther child goes below the nearer one
    if (oka && okb) {
      const bool a_first = !(tb < ta);
      stack_node[sp] = a_first ? b : a;
      stack_t[sp] = a_first ? tb : ta;
      stack_node[sp + 1] = a_first ? a : b;
      stack_t[sp + 1] = a_first ? ta : tb;
      sp += 2;
    } else if (oka || okb) {
      stack_node[sp] = oka ? a : b;
      stack_t[sp] = oka ? ta : tb;
      sp += 1;
    }
  }
  t_out[i] = best_t;
  tri_out[i] = best_tri;
}

__global__ void stream_occlusion_kernel(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        const float* __restrict__ woop, Tree tree,
                                        int32_t* __restrict__ out, int n, int tp, int c,
                                        float t_min, float t_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i, t_min);
  bool occluded = false;
  int stack_node[TREE_STACK];
  int sp = 0;
  float tn;
  if (node_entry(tree.lo, tree.hi, 0, r, t_max, &tn)) stack_node[sp++] = 0;
  while (sp > 0 && !occluded) {
    const int k = stack_node[--sp];
    const int cl = tree.cluster[k];
    if (cl >= 0) {
      for (int j = cl * c; j < (cl + 1) * c && !occluded; ++j) {
        float u, v;
        occluded = zr::woop_test(woop, tp, j, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t_min, t_max,
                                 &u, &v) < ZR_INF;
      }
      continue;
    }
    const int a = tree.left[k], b = tree.right[k];
    float ta, tb;
    const bool oka = node_entry(tree.lo, tree.hi, a, r, t_max, &ta);
    const bool okb = node_entry(tree.lo, tree.hi, b, r, t_max, &tb);
    if (oka && okb) {
      const bool a_first = !(tb < ta);
      stack_node[sp] = a_first ? b : a;
      stack_node[sp + 1] = a_first ? a : b;
      sp += 2;
    } else if (oka || okb) {
      stack_node[sp++] = oka ? a : b;
    }
  }
  out[i] = occluded ? 1 : 0;
}

}  // namespace

extern "C" int zr_stream_closest(const float* o, const float* d, const float* woop,
                                 const float* tree_lo, const float* tree_hi,
                                 const int32_t* tree_left, const int32_t* tree_right,
                                 const int32_t* tree_cluster, float* t, int32_t* tri, int n,
                                 int tp, int c, float t_min, float t_max, void* stream) {
  if (c <= 0 || tp % c) return (int)cudaErrorInvalidValue;
  const Tree tree{tree_lo, tree_hi, tree_left, tree_right, tree_cluster};
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (grid > 0) {
    stream_closest_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(o, d, woop, tree, t, tri, n,
                                                                     tp, c, t_min, t_max);
  }
  return (int)cudaGetLastError();
}

extern "C" int zr_stream_occlusion(const float* o, const float* d, const float* woop,
                                   const float* tree_lo, const float* tree_hi,
                                   const int32_t* tree_left, const int32_t* tree_right,
                                   const int32_t* tree_cluster, int32_t* out, int n, int tp,
                                   int c, float t_min, float t_max, void* stream) {
  if (c <= 0 || tp % c) return (int)cudaErrorInvalidValue;
  const Tree tree{tree_lo, tree_hi, tree_left, tree_right, tree_cluster};
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (grid > 0) {
    stream_occlusion_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(o, d, woop, tree, out, n,
                                                                       tp, c, t_min, t_max);
  }
  return (int)cudaGetLastError();
}
