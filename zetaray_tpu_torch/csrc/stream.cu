// Closest hit (kernel B8) and any hit (kernel B9) on a clustered scene.
//
// Replace _closest_stream_kernel and _occlusion_stream_kernel of the JAX
// package (accel/stream.py). Those swept tiles of shaft-sorted rays over a
// per-tile visit list of clusters; here each thread walks a tree for its
// own ray with a stack, nearer child first.
//
// Both walk accel/bvh.py walk_tree: the cluster tree with a sub-tree over
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
//   test; B8 reads the slot id beside each row only for a hit, B9 never.
// - The sign test of sweep.cuh's sweep_test: a pair whose plane distances
//   ow and dw have the same sign is dropped before the division (exact for
//   t_min >= 0, which the entry points check). B8 also drops a candidate
//   strictly beyond the best t before its edge tests; B9 returns at its
//   first hit.
// - The walk goes on with the nearer child and pushes only the farther, so
//   the stack holds at most one node for each inner node above the one
//   visited: the scene's walk_stack, counted at build (at most
//   WALK_STACK_MAX). It lives in shared memory sized from walk_stack at
//   launch, a column a thread, which measured faster than local memory
//   (PERF.md). B8's entries hold a node and its entry t, B9's a node alone.
//
// B8 keeps the tie rule of its plain version (tie groups of one cluster)
// whatever order the walk takes: the best hit is the lexicographic least of
// (t, cluster, -slot), and a node is culled only when its entry lies
// strictly beyond the best t. B9's any hit has no tie rule; it culls a node
// only beyond t_max. The slab test never culls a true hit: the node boxes
// are padded at build, the kernel pads them again by TREE_PAD_REL of the
// ray origin's largest coordinate (the Woop test rounds a hit point off its
// triangle by a few ulps of the coordinates involved) and widens the slab
// interval by a relative kWiden. A ray with a non-finite coordinate misses
// in the Woop test, culled or not; a NaN entry visits. A ray whose origin is
// near the float range (a missed primary ray's far end) is padded by as
// much and walks most of the tree.
#include "common.cuh"
#include "layout.h"  // WALK_STACK_MAX, TREE_PAD_REL

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

// Row j of the leaf-ordered rows (rows[3j .. 3j+2] = w, u, v) against the
// ray: sweep.cuh sweep_test, its rows loaded as they are needed. Whether the
// ray hits with t_min < t < t_lt and t <= t_le; then its t in *t_out.
__device__ __forceinline__ bool row_hit(const float4* __restrict__ rows, int j, const Ray& r,
                                        float t_lt, float t_le, float* t_out) {
  const float4 q = __ldg(rows + 3 * j);
  const float dw = q.x * r.dx + q.y * r.dy + q.z * r.dz;
  const float ow = q.x * r.ox + q.y * r.oy + q.z * r.oz + q.w;
  if (fabsf(dw) < 1e-12f || ow == 0.f || (ow < 0.f) == (dw < 0.f)) return false;
  const float t = -ow / dw;
  if (!(t > r.t_min) || !(t < t_lt) || !(t <= t_le)) return false;
  const float4 a = __ldg(rows + 3 * j + 1);
  const float u = (a.x * r.ox + a.y * r.oy + a.z * r.oz + a.w) +
                  t * (a.x * r.dx + a.y * r.dy + a.z * r.dz);
  if (!(u >= 0.0f)) return false;
  const float4 b = __ldg(rows + 3 * j + 2);
  const float v = (b.x * r.ox + b.y * r.oy + b.z * r.oz + b.w) +
                  t * (b.x * r.dx + b.y * r.dy + b.z * r.dz);
  if (!(v >= 0.0f) || !(u + v <= 1.0f)) return false;
  *t_out = t;
  return true;
}

constexpr int kWalkBlock = 128;  // threads a block of B8 and B9

// The walk of B8's tree (accel/bvh.py walk_tree) for ray r: node k is
// nodes[4k .. 4k+3] = (child 0 lo.x, hi.x, lo.y, hi.y), (child 1 lo.x, hi.x,
// lo.y, hi.y), (lo.z, hi.z of child 0, of child 1), (ref0, ref1, -, -) as
// int bits. A ref >= 0 is an inner node; a ref < 0 a leaf of rows [first,
// first + count) with ~ref = first * 16 + count. The query q decides:
//   q.t_hi()               a child whose entry lies strictly beyond it is culled
//   q.leaf(r, first, n)    tests a leaf's rows; true ends the walk
//   q.push(e, node, t)     stores the farther child in stack entry e
//   q.pop(sp, k)           the next node from the sp entries in use, or false
// Returns whether a leaf ended the walk.
template <class Query>
__device__ __forceinline__ bool walk(const float4* __restrict__ nodes, const Ray& r, Query& q) {
  int sp = 0;
  int k = 0;  // the node to visit: the root's box is its children's
  for (;;) {
    if (k >= 0) {
      const float4* nd = nodes + 4 * (size_t)k;
      const float4 bx0 = __ldg(nd), bx1 = __ldg(nd + 1), bz = __ldg(nd + 2), ref = __ldg(nd + 3);
      const float t_hi = q.t_hi();
      float ta, tb;
      const bool oka = box_entry(bx0.x, bx0.z, bz.x, bx0.y, bx0.w, bz.y, r, t_hi, &ta);
      const bool okb = box_entry(bx1.x, bx1.z, bz.z, bx1.y, bx1.w, bz.w, r, t_hi, &tb);
      const int ra = __float_as_int(ref.x), rb = __float_as_int(ref.y);
      if (oka && okb) {  // the farther child waits on the stack
        const bool a_first = !(tb < ta);
        q.push(sp++, a_first ? rb : ra, a_first ? tb : ta);
        k = a_first ? ra : rb;
        continue;
      }
      if (oka || okb) {
        k = oka ? ra : rb;
        continue;
      }
    } else if (q.leaf(r, (~k) >> 4, (~k) & 15)) {
      return true;
    }
    if (!q.pop(sp, k)) return false;
  }
}

// B8's query: the least (t, cluster, -slot) with t_min < t < t_lt. Entry e
// of thread x's stack at [e * kWalkBlock + x]: a warp's pushes and pops hit
// 32 banks; the nodes first, then their entry t.
struct Closest {
  const float4* rows;
  const int32_t* slot;  // the slot of each row
  int c;                // the cluster size
  float t_lt, t_max;
  int* stack_node;
  float* stack_t;
  int x;
  float best_t = ZR_INF;
  int best_c = 0x7fffffff, best_slot = -1;

  __device__ __forceinline__ float t_hi() const { return fminf(best_t, t_max); }

  __device__ __forceinline__ bool leaf(const Ray& r, int first, int count) {
    for (int j = first; j < first + count; ++j) {
      float t;
      // a t equal to the best goes on: a lower cluster or a higher slot wins
      if (!row_hit(rows, j, r, t_lt, best_t, &t)) continue;
      const int s = __ldg(slot + j);
      const int cl = s / c;
      if (t < best_t || cl < best_c || (cl == best_c && s > best_slot)) {
        best_t = t;
        best_c = cl;
        best_slot = s;
      }
    }
    return false;
  }

  __device__ __forceinline__ void push(int e, int node, float t) {
    stack_node[e * kWalkBlock + x] = node;
    stack_t[e * kWalkBlock + x] = t;
  }

  __device__ __forceinline__ bool pop(int& sp, int& k) const {
    // an equal t in a lower cluster still counts
    while (sp > 0 && stack_t[(sp - 1) * kWalkBlock + x] > best_t) --sp;
    if (sp == 0) return false;
    --sp;
    k = stack_node[sp * kWalkBlock + x];
    return true;
  }
};

// B9's query: any hit with t_min < t < t_lt; the stack holds nodes only.
struct AnyHit {
  const float4* rows;
  float t_lt, t_max;
  int* stack_node;
  int x;

  __device__ __forceinline__ float t_hi() const { return t_max; }

  __device__ __forceinline__ bool leaf(const Ray& r, int first, int count) const {
    float t;
    for (int j = first; j < first + count; ++j) {
      if (row_hit(rows, j, r, t_lt, ZR_INF, &t)) return true;
    }
    return false;
  }

  __device__ __forceinline__ void push(int e, int node, float) {
    stack_node[e * kWalkBlock + x] = node;
  }

  __device__ __forceinline__ bool pop(int& sp, int& k) const {
    if (sp == 0) return false;
    k = stack_node[--sp * kWalkBlock + x];
    return true;
  }
};

__global__ void __launch_bounds__(kWalkBlock)
stream_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float4* __restrict__ nodes, const float4* __restrict__ rows,
                      const int32_t* __restrict__ slot, float* __restrict__ t_out,
                      int32_t* __restrict__ tri_out, int n, int c, int stack, float t_min,
                      float t_max) {
  extern __shared__ int walk_shared[];
  const int x = threadIdx.x;
  const int i = blockIdx.x * kWalkBlock + x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i, t_min);
  // a hit has t < ZR_INF, as in the plain version
  Closest q{rows, slot, c, fminf(t_max, ZR_INF), t_max, walk_shared,
            reinterpret_cast<float*>(walk_shared + stack * kWalkBlock), x};
  walk(nodes, r, q);
  t_out[i] = q.best_t;
  tri_out[i] = q.best_slot;
}

__global__ void __launch_bounds__(kWalkBlock)
stream_any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float4* __restrict__ nodes, const float4* __restrict__ rows,
                      int32_t* __restrict__ out, int n, float t_min, float t_max) {
  extern __shared__ int walk_shared[];
  const int x = threadIdx.x;
  const int i = blockIdx.x * kWalkBlock + x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i, t_min);
  AnyHit q{rows, fminf(t_max, ZR_INF), t_max, walk_shared, x};
  out[i] = walk(nodes, r, q) ? 1 : 0;
}

// Launches a walk kernel over n rays with a shared stack of `stack` entries
// of `entry` bytes a thread.
template <class Kernel, class... Args>
int launch_walk(Kernel kernel, int n, int stack, size_t entry, void* stream, Args... args) {
  const size_t shared = (size_t)stack * kWalkBlock * entry;
  if (shared > 48 * 1024) {  // a block takes more than 48 KiB only when asked
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (n + kWalkBlock - 1) / kWalkBlock;
  if (grid > 0) kernel<<<grid, kWalkBlock, shared, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
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
  return launch_walk(stream_closest_kernel, n, stack, sizeof(int) + sizeof(float), stream, o, d,
                     reinterpret_cast<const float4*>(nodes),
                     reinterpret_cast<const float4*>(rows), slot, t, tri, n, c, stack, t_min,
                     t_max);
}

// nodes, rows, stack: as for zr_stream_closest; out: 1 where a hit lies in
// (t_min, t_max), else 0.
extern "C" int zr_stream_occlusion(const float* o, const float* d, const int32_t* nodes,
                                   const float* rows, int32_t* out, int n, int stack,
                                   float t_min, float t_max, void* stream) {
  if (stack < 1 || stack > WALK_STACK_MAX || !(t_min >= 0.f)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_walk(stream_any_hit_kernel, n, stack, sizeof(int), stream, o, d,
                     reinterpret_cast<const float4*>(nodes),
                     reinterpret_cast<const float4*>(rows), out, n, t_min, t_max);
}
