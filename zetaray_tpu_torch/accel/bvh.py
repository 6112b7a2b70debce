"""Host-side BVH in numpy: the binned-SAH build, cluster leaves, and the
traversal tree over the cluster boxes.

A copy of the JAX package's ``accel/bvh.py`` (``build_bvh`` and
``BVH.cluster_aabbs``), so that the clustered upload reorders triangles
exactly as the JAX package does. On top of it,
:func:`cluster_tree` builds the tree the streaming kernels B8/B9 walk, one
leaf per cluster, from the ``[M, 8]`` cluster box rows alone: a scene
carried over from JAX gets the same tree as one uploaded here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_N_BINS = 16
# Deepest tree the kernels' fixed traversal stack takes (layout.h TREE_STACK):
# a depth-first walk that pushes both children holds at most depth + 1 nodes.
TREE_STACK = 64
# Node boxes grow by this share of the scene's largest coordinate: the Woop
# test rounds a hit point off its triangle by a few ulps of the coordinates,
# and cluster boxes of an axis-aligned wall have zero thickness.
TREE_PAD_REL = 2.0**-16


@dataclass
class BVH:
    # nodes, SoA; node 0 is the root
    lo: np.ndarray  # [M, 3]
    hi: np.ndarray  # [M, 3]
    left: np.ndarray  # [M] child id or -1 for leaves
    right: np.ndarray  # [M]
    first: np.ndarray  # [M] leaf: first triangle (post-permutation)
    count: np.ndarray  # [M] leaf: triangle count (0 for inner nodes)
    perm: np.ndarray  # [T] original triangle index per new slot

    @property
    def num_nodes(self) -> int:
        return int(self.lo.shape[0])

    def leaves(self):
        return np.nonzero(self.count > 0)[0]

    def cluster_aabbs(self):
        """(lo, hi, first, count) arrays for leaf clusters, build order."""
        ls = self.leaves()
        return self.lo[ls], self.hi[ls], self.first[ls], self.count[ls]


def build_bvh(v0, v1, v2, leaf_size: int = 64) -> BVH:
    """Binned-SAH top-down build. O(T log T) host time."""
    t = v0.shape[0]
    lo_t = np.minimum(np.minimum(v0, v1), v2)
    hi_t = np.maximum(np.maximum(v0, v1), v2)
    cent = (lo_t + hi_t) * 0.5

    order = np.arange(t)
    nodes_lo, nodes_hi = [], []
    nodes_left, nodes_right = [], []
    nodes_first, nodes_count = [], []
    out_perm = np.empty(t, np.int64)
    out_cursor = 0

    def new_node():
        nodes_lo.append(None)
        nodes_hi.append(None)
        nodes_left.append(-1)
        nodes_right.append(-1)
        nodes_first.append(0)
        nodes_count.append(0)
        return len(nodes_lo) - 1

    # iterative stack: (node_id, index array)
    root = new_node()
    stack = [(root, order)]
    while stack:
        nid, idx = stack.pop()
        nodes_lo[nid] = lo_t[idx].min(0)
        nodes_hi[nid] = hi_t[idx].max(0)
        n = idx.shape[0]
        if n <= leaf_size:
            nodes_first[nid] = out_cursor
            nodes_count[nid] = n
            out_perm[out_cursor : out_cursor + n] = idx
            out_cursor += n
            continue
        # binned SAH over the widest centroid axis
        c = cent[idx]
        c_lo = c.min(0)
        c_hi = c.max(0)
        axis = int(np.argmax(c_hi - c_lo))
        extent = c_hi[axis] - c_lo[axis]
        if extent < 1e-12:
            # degenerate spread: median split
            half = n // 2
            part = np.argsort(c[:, axis])
            l_idx, r_idx = idx[part[:half]], idx[part[half:]]
        else:
            bins = np.minimum(
                ((c[:, axis] - c_lo[axis]) / extent * _N_BINS).astype(np.int64),
                _N_BINS - 1,
            )
            counts = np.bincount(bins, minlength=_N_BINS)
            bin_lo = np.full((_N_BINS, 3), np.inf)
            bin_hi = np.full((_N_BINS, 3), -np.inf)
            for b in range(_N_BINS):
                m = bins == b
                if m.any():
                    bin_lo[b] = lo_t[idx[m]].min(0)
                    bin_hi[b] = hi_t[idx[m]].max(0)

            def area(lo, hi):
                d = np.maximum(hi - lo, 0)
                return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

            # prefix/suffix sweeps
            lf_lo = np.minimum.accumulate(bin_lo, 0)
            lf_hi = np.maximum.accumulate(bin_hi, 0)
            rt_lo = np.minimum.accumulate(bin_lo[::-1], 0)[::-1]
            rt_hi = np.maximum.accumulate(bin_hi[::-1], 0)[::-1]
            n_l = np.cumsum(counts)[:-1]
            n_r = n - n_l
            cost = area(lf_lo[:-1], lf_hi[:-1]) * n_l + area(rt_lo[1:], rt_hi[1:]) * n_r
            cost = np.where((n_l == 0) | (n_r == 0), np.inf, cost)
            split = int(np.argmin(cost))
            go_left = bins <= split
            if not go_left.any() or go_left.all():
                half = n // 2
                part = np.argsort(c[:, axis])
                l_idx, r_idx = idx[part[:half]], idx[part[half:]]
            else:
                l_idx, r_idx = idx[go_left], idx[~go_left]
        lid = new_node()
        rid = new_node()
        nodes_left[nid] = lid
        nodes_right[nid] = rid
        stack.append((rid, r_idx))
        stack.append((lid, l_idx))

    return BVH(
        lo=np.asarray(nodes_lo, np.float32),
        hi=np.asarray(nodes_hi, np.float32),
        left=np.asarray(nodes_left, np.int32),
        right=np.asarray(nodes_right, np.int32),
        first=np.asarray(nodes_first, np.int32),
        count=np.asarray(nodes_count, np.int32),
        perm=out_perm,
    )


def _outward(x: np.ndarray, down: bool) -> np.ndarray:
    """float64 -> float32 rounded toward -inf (``down``) or +inf."""
    y = x.astype(np.float32)
    if down:
        return np.where(y > x, np.nextafter(y, np.float32(-np.inf)), y).astype(np.float32)
    return np.where(y < x, np.nextafter(y, np.float32(np.inf)), y).astype(np.float32)


def cluster_tree(cluster_aabb: np.ndarray) -> dict:
    """The traversal tree over the clusters of ``cluster_aabb`` [M, 8] (rows
    lo.xyz, hi.xyz, pad): ``build_bvh`` over the boxes with one cluster per
    leaf. Returns flat node arrays ``tree_lo``/``tree_hi`` [K, 3] float32
    (each box grown by ``TREE_PAD_REL`` of the largest coordinate and rounded
    outward), ``tree_left``/``tree_right`` [K] int32 (-1 at a leaf) and
    ``tree_cluster`` [K] int32 (the leaf's cluster, -1 at an inner node).
    Node 0 is the root. Raises if the tree is deeper than ``TREE_STACK``
    allows."""
    box = np.asarray(cluster_aabb, np.float32)
    lo, hi = box[:, 0:3], box[:, 3:6]
    bvh = build_bvh(lo, hi, lo, leaf_size=1)
    cluster = np.full(bvh.num_nodes, -1, np.int32)
    leaf = bvh.count > 0
    cluster[leaf] = bvh.perm[bvh.first[leaf]]
    depth = np.zeros(bvh.num_nodes, np.int64)
    for k in range(bvh.num_nodes):  # children are created after their parent
        if not leaf[k]:
            depth[bvh.left[k]] = depth[bvh.right[k]] = depth[k] + 1
    if depth.max() + 1 > TREE_STACK:
        raise ValueError(f"cluster tree depth {depth.max()} exceeds the traversal stack "
                         f"({TREE_STACK})")
    pad = TREE_PAD_REL * float(max(np.abs(lo).max(), np.abs(hi).max()))
    return dict(
        tree_lo=_outward(bvh.lo.astype(np.float64) - pad, down=True),
        tree_hi=_outward(bvh.hi.astype(np.float64) + pad, down=False),
        tree_left=bvh.left, tree_right=bvh.right, tree_cluster=cluster,
    )
