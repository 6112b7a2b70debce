// Closest hit (kernel B8) and any hit (kernel B9) on a clustered scene.
//
// Replace _closest_stream_kernel and _occlusion_stream_kernel of the JAX
// package (accel/stream.py). Those swept tiles of shaft-sorted rays over a
// per-tile visit list of clusters; here each thread walks a tree for its
// own ray with a stack, nearer child first.
//
// B9 walks the tree over the cluster boxes (accel/bvh.py cluster_tree) and
// runs the Woop test of common.cuh over the C slots of each cluster it
// reaches, reading the woop [4, 3, tp] table in place, until the first hit.
// Its stack of TREE_STACK nodes is in local memory.
//
// B8 walks accel/bvh.py walk_tree: the cluster tree with a sub-tree over
// each cluster's real slots below it, leaves of at most LEAF_SIZE
// triangles. A camera ray of the 139,266-triangle box reaches about one
// cluster of 256 slots, so what the walk costs is the tests inside the
// cluster: leaves of a few triangles cut them from a whole cluster's slots
// (pads included) to a few leaves' worth. What the design does about the
// price of each step:
// - A node holds both children's boxes and refs in four 16-byte words, read
//   with four vector loads; the child boxes are tested together.
// - The rows of the real slots lie in leaf order, three float4 a triangle
//   (the w, u and v rows of its Woop transform, SceneBuffers.leaf_rows), so
//   a test is three 16-byte loads, and the first alone decides the sign
//   test; the slot id beside each row is read only for a hit.
// - The sign test and the pruning of sweep.cuh's sweep_test: a pair whose
//   plane distances ow and dw have the same sign is dropped before the
//   division (exact for t_min >= 0, which the entry point checks), a
//   candidate strictly beyond the best t before its edge tests.
// - The walk goes on with the nearer child and pushes only the farther, so
//   the stack holds at most one node for each inner node above the one
//   visited: the scene's walk_stack, counted at build (at most
//   WALK_STACK_MAX). It lives in shared memory sized from walk_stack at
//   launch, a column a thread, which measured faster than local memory
//   (PERF.md).
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
// ray's far end) is padded by as much and walks most of the tree.
#include "common.cuh"
#include "layout.h"  // TREE_STACK, WALK_STACK_MAX, TREE_PAD_REL

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

// The ray's entry t into the box lo..hi, in *t_near. Returns false (cull)
// when the widened slab interval is empty, ends before t_min or starts
// strictly beyond t_hi.
__device__ __forceinline__ bool box_entry(float lx, float ly, float lz, float hx, float hy,
                                          float hz, const Ray& r, float t_hi, float* t_near) {
  const float x0 = (lx - r.pad - r.ox) * r.ivx, x1 = (hx + r.pad - r.ox) * r.ivx;
  const float y0 = (ly - r.pad - r.oy) * r.ivy, y1 = (hy + r.pad - r.oy) * r.ivy;
  const float z0 = (lz - r.pad - r.oz) * r.ivz, z1 = (hz + r.pad - r.oz) * r.ivz;
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

// The ray's entry t into node k's box of the cluster tree.
__device__ __forceinline__ bool node_entry(const float* __restrict__ lo,
                                           const float* __restrict__ hi, int k, const Ray& r,
                                           float t_hi, float* t_near) {
  const float* l = lo + 3 * k;
  const float* h = hi + 3 * k;
  return box_entry(l[0], l[1], l[2], h[0], h[1], h[2], r, t_hi, t_near);
}

struct Tree {
  const float* lo;
  const float* hi;
  const int32_t* left;
  const int32_t* right;
  const int32_t* cluster;
};

// B8's tree (accel/bvh.py walk_tree): node k is nodes[4k .. 4k+3] = (child 0
// lo.x, hi.x, lo.y, hi.y), (child 1 lo.x, hi.x, lo.y, hi.y), (lo.z, hi.z of
// child 0, of child 1), (ref0, ref1, -, -) as int bits. A ref >= 0 is an
// inner node; a ref < 0 a leaf of rows [first, first + count) with
// ~ref = first * 16 + count. Row j is rows[3j .. 3j+2] (w, u, v) of slot
// slot[j].
struct Walk {
  const float4* nodes;
  const float4* rows;
  const int32_t* slot;
};

// The rows of one leaf against the ray: keeps the least (t, cluster, -slot)
// with t_min < t < t_lt in *best_t, *best_c, *best_slot.
__device__ __forceinline__ void leaf_test(const Walk& w, int first, int count, const Ray& r,
                                          float t_lt, int c, float* best_t, int* best_c,
                                          int* best_slot) {
  for (int j = first; j < first + count; ++j) {
    // sweep.cuh sweep_test, its rows loaded as they are needed
    const float4 q = __ldg(w.rows + 3 * j);
    const float dw = q.x * r.dx + q.y * r.dy + q.z * r.dz;
    const float ow = q.x * r.ox + q.y * r.oy + q.z * r.oz + q.w;
    if (fabsf(dw) < 1e-12f || ow == 0.f || (ow < 0.f) == (dw < 0.f)) continue;
    const float t = -ow / dw;
    // a t equal to the best goes on: a lower cluster or a higher slot wins
    if (!(t > r.t_min) || !(t < t_lt) || !(t <= *best_t)) continue;
    const float4 a = __ldg(w.rows + 3 * j + 1);
    const float u = (a.x * r.ox + a.y * r.oy + a.z * r.oz + a.w) +
                    t * (a.x * r.dx + a.y * r.dy + a.z * r.dz);
    if (!(u >= 0.0f)) continue;
    const float4 b = __ldg(w.rows + 3 * j + 2);
    const float v = (b.x * r.ox + b.y * r.oy + b.z * r.oz + b.w) +
                    t * (b.x * r.dx + b.y * r.dy + b.z * r.dz);
    if (!(v >= 0.0f) || !(u + v <= 1.0f)) continue;
    const int s = __ldg(w.slot + j);
    const int cl = s / c;
    if (t < *best_t || cl < *best_c || (cl == *best_c && s > *best_slot)) {
      *best_t = t;
      *best_c = cl;
      *best_slot = s;
    }
  }
}

constexpr int kWalkBlock = 128;  // B8's threads a block

// The bytes of B8's shared stack of `stack` entries a thread.
inline size_t walk_stack_bytes(int stack) {
  return (size_t)stack * kWalkBlock * (sizeof(int) + sizeof(float));
}

__global__ void __launch_bounds__(kWalkBlock)
stream_closest_kernel(const float* __restrict__ o, const float* __restrict__ d, Walk w,
                      float* __restrict__ t_out, int32_t* __restrict__ tri_out, int n, int c,
                      int stack, float t_min, float t_max) {
  // entry e of thread x's stack at [e * kWalkBlock + x]: a warp's pushes and
  // pops hit 32 banks; the nodes first, then their entry t
  extern __shared__ int walk_shared[];
  int* const stack_node = walk_shared;
  float* const stack_t = reinterpret_cast<float*>(walk_shared + stack * kWalkBlock);
  const int x = threadIdx.x;
  const int i = blockIdx.x * kWalkBlock + x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i, t_min);
  const float t_lt = fminf(t_max, ZR_INF);  // a hit has t < ZR_INF, as in the plain version
  float best_t = ZR_INF;
  int best_slot = -1, best_c = 0x7fffffff;
  int sp = 0;
  int k = 0;  // the node to visit: the root's box is its children's
  for (;;) {
    if (k >= 0) {
      const float4* nd = w.nodes + 4 * (size_t)k;
      const float4 bx0 = __ldg(nd), bx1 = __ldg(nd + 1), bz = __ldg(nd + 2), ref = __ldg(nd + 3);
      const float t_hi = fminf(best_t, t_max);
      float ta, tb;
      const bool oka = box_entry(bx0.x, bx0.z, bz.x, bx0.y, bx0.w, bz.y, r, t_hi, &ta);
      const bool okb = box_entry(bx1.x, bx1.z, bz.z, bx1.y, bx1.w, bz.w, r, t_hi, &tb);
      const int ra = __float_as_int(ref.x), rb = __float_as_int(ref.y);
      if (oka && okb) {  // the farther child waits on the stack
        const bool a_first = !(tb < ta);
        stack_node[sp * kWalkBlock + x] = a_first ? rb : ra;
        stack_t[sp * kWalkBlock + x] = a_first ? tb : ta;
        ++sp;
        k = a_first ? ra : rb;
        continue;
      }
      if (oka || okb) {
        k = oka ? ra : rb;
        continue;
      }
    } else {
      leaf_test(w, (~k) >> 4, (~k) & 15, r, t_lt, c, &best_t, &best_c, &best_slot);
    }
    // an equal t in a lower cluster still counts
    while (sp > 0 && stack_t[(sp - 1) * kWalkBlock + x] > best_t) --sp;
    if (sp == 0) break;
    --sp;
    k = stack_node[sp * kWalkBlock + x];
  }
  t_out[i] = best_t;
  tri_out[i] = best_slot;
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

// nodes, rows, slot, stack: SceneBuffers.walk_nodes, leaf_rows(), leaf_slot
// and walk_stack; c: the cluster size.
extern "C" int zr_stream_closest(const float* o, const float* d, const int32_t* nodes,
                                 const float* rows, const int32_t* slot, float* t, int32_t* tri,
                                 int n, int c, int stack, float t_min, float t_max,
                                 void* stream) {
  if (c <= 0 || stack < 1 || stack > WALK_STACK_MAX || !(t_min >= 0.f)) {
    return (int)cudaErrorInvalidValue;
  }
  const Walk w{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(rows),
               slot};
  const size_t shared = walk_stack_bytes(stack);
  if (shared > 48 * 1024) {  // a block takes more than 48 KiB only when asked
    const cudaError_t err = cudaFuncSetAttribute(
        stream_closest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (n + kWalkBlock - 1) / kWalkBlock;
  if (grid > 0) {
    stream_closest_kernel<<<grid, kWalkBlock, shared, (cudaStream_t)stream>>>(
        o, d, w, t, tri, n, c, stack, t_min, t_max);
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
