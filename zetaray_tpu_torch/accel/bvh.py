"""Host-side BVH in numpy: the binned-SAH build, cluster leaves, the
traversal tree over the cluster boxes, and the sub-trees below them.

A copy of the JAX package's ``accel/bvh.py`` (``build_bvh`` and
``BVH.cluster_aabbs``), so that the clustered upload reorders triangles
exactly as the JAX package does. On top of it, :func:`cluster_tree` builds
the tree over the clusters, one leaf per cluster, from the ``[M, 8]``
cluster box rows alone, and :func:`walk_tree` the tree that the
closest-hit kernel B8 and the any-hit kernel B9 walk: the cluster tree with
a sub-tree over each cluster's real slots below it, leaves of at most
``LEAF_SIZE`` triangles. These read only tables that every clustered scene
carries (the cluster boxes, the Woop table, ``v0``/``e1``/``e2``), so a
scene carried over from JAX gets the same tree as one uploaded here.
:func:`chain_tree` is the deepest tree over the clusters, on which the
tests hold the walks' stacks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_N_BINS = 16
# Most stack entries a walk of B8 or B9 may need (layout.h WALK_STACK_MAX).
# A walk goes on with the nearer child and pushes the farther, so it holds
# at most one node for each inner node above the one it visits, cluster
# tree and sub-tree together (``walk_stack``: 20 on the 139,266-triangle
# box). The stack lives in shared memory, sized at launch from the scene's
# ``walk_stack``, for each of a block's 128 threads 8 bytes an entry in B8
# and 4 in B9: 192 entries are 192 KiB in B8, under the 227 KiB a block of
# an H100 may have.
WALK_STACK_MAX = 192
# Most triangles in a leaf of the walk's sub-trees (at most 15: a leaf ref
# holds its count in 4 bits).
LEAF_SIZE = 2
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
    Node 0 is the root. It is :func:`walk_tree`'s input."""
    box = np.asarray(cluster_aabb, np.float32)
    lo, hi = box[:, 0:3], box[:, 3:6]
    bvh = build_bvh(lo, hi, lo, leaf_size=1)
    cluster = np.full(bvh.num_nodes, -1, np.int32)
    leaf = bvh.count > 0
    cluster[leaf] = bvh.perm[bvh.first[leaf]]
    return _tree(box, bvh.lo, bvh.hi, bvh.left, bvh.right, cluster)


def chain_tree(cluster_aabb: np.ndarray) -> dict:
    """The deepest traversal tree over the clusters of ``cluster_aabb``, in
    the form of :func:`cluster_tree`: inner node 2k holds cluster k's leaf
    (node 2k + 1) and the tree over clusters k+1.. (node 2k + 2), so the
    tree is M - 1 deep. A valid tree for both walks, if a slow one."""
    box = np.asarray(cluster_aabb, np.float32)
    m = box.shape[0]
    k = np.arange(2 * m - 1)
    cluster = np.where(k % 2 == 1, k // 2, -1).astype(np.int32)
    cluster[-1] = m - 1
    inner = cluster < 0
    left = np.where(inner, k + 1, -1).astype(np.int32)
    right = np.where(inner, k + 2, -1).astype(np.int32)
    # an inner node's box is that of the clusters k // 2.. below it
    first = np.where(inner, k // 2, cluster)
    lo = np.minimum.accumulate(box[::-1, 0:3], 0)[::-1]
    hi = np.maximum.accumulate(box[::-1, 3:6], 0)[::-1]
    lo = np.where(inner[:, None], lo[first], box[first, 0:3])
    hi = np.where(inner[:, None], hi[first], box[first, 3:6])
    return _tree(box, lo, hi, left, right, cluster)


def _tree(box, lo, hi, left, right, cluster) -> dict:
    """A cluster tree's arrays, its boxes padded."""
    scale = float(max(np.abs(box[:, 0:3]).max(), np.abs(box[:, 3:6]).max()))
    tree_lo, tree_hi = _pad_box(lo, hi, TREE_PAD_REL * scale)
    return dict(tree_lo=tree_lo, tree_hi=tree_hi, tree_left=np.asarray(left, np.int32),
                tree_right=np.asarray(right, np.int32), tree_cluster=cluster)


def _pad_box(lo: np.ndarray, hi: np.ndarray, pad: float):
    """Boxes grown by ``pad`` and rounded outward to float32."""
    return (_outward(np.asarray(lo, np.float64) - pad, down=True),
            _outward(np.asarray(hi, np.float64) + pad, down=False))


def _segment_boxes(lo: np.ndarray, hi: np.ndarray, a: np.ndarray, b: np.ndarray):
    """Union of boxes [a, b) of lo/hi [R, 3] for each segment (a < b, sorted
    and disjoint)."""
    if a.size == 0:
        return np.zeros((0, 3)), np.zeros((0, 3))
    idx = np.stack([a, b], 1).ravel()
    lo_s = np.concatenate([lo, lo[-1:]])  # b may equal R
    hi_s = np.concatenate([hi, hi[-1:]])
    return np.minimum.reduceat(lo_s, idx)[::2], np.maximum.reduceat(hi_s, idx)[::2]


def _depth(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Depth of each node of a tree whose children come after their parent."""
    depth = np.zeros(left.shape[0], np.int64)
    for k in range(left.shape[0]):
        if left[k] >= 0:
            depth[left[k]] = depth[right[k]] = depth[k] + 1
    return depth


def walk_tree(tree: dict, cluster_size: int, woop: np.ndarray, v0: np.ndarray,
              e1: np.ndarray, e2: np.ndarray) -> dict:
    """The tree that kernels B8 and B9 walk: the cluster tree ``tree`` (from
    :func:`cluster_tree`) with, below each cluster leaf, a sub-tree over the
    cluster's real slots (non-zero Woop rows; a pad slot's all-zero rows
    never hit) with leaves of at most ``LEAF_SIZE`` triangles.

    Each sub-tree is a median split on the widest axis of its triangles'
    box centres, built for all clusters at once a level at a time; a node
    holds ``ceil(leaves / 2) * LEAF_SIZE`` triangles on its left, so every
    leaf but the last of a cluster is full and the sub-tree is balanced.
    The slots keep their ids and clusters: only the rows of the walks' table
    (``SceneBuffers.leaf_rows``) are put in leaf order.

    Returns ``walk_nodes`` [K, 16] int32, one node a row, node 0 the root:
    words 0-3 child 0's box x and y (lo.x, hi.x, lo.y, hi.y), 4-7 child 1's,
    8-11 both boxes' z (lo0, hi0, lo1, hi1), all float32 bits, 12-13 (ref0,
    ref1) and 14-15 zero. A ref >= 0 is an inner node; a ref < 0 a leaf of
    ``count`` rows from row ``first``, ~ref = first * 16 + count. A cluster's
    box is the cluster tree's; a sub-tree box is grown by ``TREE_PAD_REL``
    of the cluster boxes' largest coordinate and rounded outward, as the
    cluster tree's are. ``leaf_slot`` [R] int32: the slot of each row in
    leaf order. ``walk_stack``: the most stack entries a walk can need,
    which sizes the walks' stacks at launch. And what ``scene.refit``
    needs to recompute every box from moved triangles: ``walk_span`` [K, 4]
    int32, each child's span (a0, b0, a1, b1), in the first ``walk_top``
    nodes (the cluster tree's) a span of ``walk_cluster_order`` [M] int32
    (the clusters in the cluster tree's leaf order; a child's box is its
    clusters' boxes padded), in the others a span of the rows in leaf order
    (a child's box is its rows' triangles padded).
    Raises if the stack is more than ``WALK_STACK_MAX``."""
    tp = woop.shape[1] // 3
    slots = np.nonzero((np.asarray(woop).reshape(4, 3, tp) != 0).any((0, 1)))[0]
    v0 = np.asarray(v0, np.float64)[slots]
    p1 = v0 + np.asarray(e1, np.float64)[slots]
    p2 = v0 + np.asarray(e2, np.float64)[slots]
    tri_lo = np.minimum(np.minimum(v0, p1), p2)
    tri_hi = np.maximum(np.maximum(v0, p1), p2)
    cent = (tri_lo + tri_hi) * 0.5
    m = tree["tree_cluster"].max() + 1
    cl_start = np.searchsorted(slots // cluster_size, np.arange(m + 1))
    order = np.arange(slots.shape[0])

    def split(a, b):
        """Sort each segment [a, b) along the widest axis of its centres
        (in place in ``order``); the left child's end."""
        n = b - a
        end = np.cumsum(n)
        seg = np.repeat(np.arange(a.shape[0]), n)
        rows = np.arange(end[-1]) - np.repeat(end - n, n) + np.repeat(a, n)
        c = cent[order[rows]]
        c_lo, c_hi = _segment_boxes(c, c, end - n, end)
        axis = np.argmax(c_hi - c_lo, 1)
        order[rows] = order[rows[np.lexsort((c[np.arange(rows.shape[0]), axis[seg]], seg))]]
        leaves = (n + LEAF_SIZE - 1) // LEAF_SIZE
        return a + (leaves + 1) // 2 * LEAF_SIZE

    def leaf(sa, sb):
        return ~(sa * 16 + sb - sa)

    # the sub-tree nodes a level at a time, numbered in that order after the
    # cluster tree's inner nodes; each node's children as row segments
    n_top = int((tree["tree_cluster"] < 0).sum())
    big = np.diff(cl_start) > LEAF_SIZE
    a, b = cl_start[:-1][big], cl_start[1:][big]
    sub_root = leaf(cl_start[:-1], cl_start[1:])
    sub_root[big] = n_top + np.arange(a.shape[0])
    kid_a, kid_b, kid_ref, node_cl, node_level = [], [], [], [], []
    next_id = n_top + a.shape[0]
    while a.size:
        mid = split(a, b)
        ca, cb = np.stack([a, mid], 1).ravel(), np.stack([mid, b], 1).ravel()
        inner = cb - ca > LEAF_SIZE
        kid_a.append(ca), kid_b.append(cb)
        kid_ref.append(np.where(inner, next_id + np.cumsum(inner) - 1, leaf(ca, cb)))
        node_cl.append(np.searchsorted(cl_start, a, "right") - 1)
        node_level.append(np.full(a.shape[0], len(node_level)))
        next_id += int(inner.sum())
        a, b = ca[inner], cb[inner]
    kid_a, kid_b, kid_ref, node_cl, node_level = (
        np.concatenate(x) if x else np.zeros(0, np.int64)
        for x in (kid_a, kid_b, kid_ref, node_cl, node_level))
    pad = TREE_PAD_REL * float(max(np.abs(tree["tree_lo"]).max(), np.abs(tree["tree_hi"]).max()))
    tri_lo, tri_hi = tri_lo[order], tri_hi[order]
    n_sub = node_cl.shape[0]
    nodes = np.zeros((n_top + n_sub, 16), np.int32)
    f = nodes[:, :12].view(np.float32)

    def put(rows, side, lo, hi, r):
        f[rows, 4 * side : 4 * side + 4] = np.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], 1)
        f[rows, 8 + 2 * side : 10 + 2 * side] = np.stack([lo[:, 2], hi[:, 2]], 1)
        nodes[rows, 12 + side] = r

    lo, hi = _pad_box(*_segment_boxes(tri_lo, tri_hi, kid_a, kid_b), pad)
    for side in (0, 1):
        put(n_top + np.arange(n_sub), side, lo[side::2], hi[side::2], kid_ref[side::2])
    # the cluster tree on top: a cluster leaf's child is its sub-tree's root
    cl = np.asarray(tree["tree_cluster"])
    left, right = np.asarray(tree["tree_left"]), np.asarray(tree["tree_right"])
    top_id = np.cumsum(cl < 0) - 1
    top = np.nonzero(cl < 0)[0]
    for side, kids in enumerate((left[top], right[top])):
        r = np.where(cl[kids] >= 0, sub_root[np.maximum(cl[kids], 0)], top_id[kids])
        put(top_id[top], side, tree["tree_lo"][kids], tree["tree_hi"][kids], r)
    # each child's span: the cluster tree's over its leaf order, the
    # sub-trees' over the rows
    count = (cl >= 0).astype(np.int64)
    for k in range(cl.shape[0] - 1, -1, -1):
        if cl[k] < 0:
            count[k] = count[left[k]] + count[right[k]]
    offset = np.zeros(cl.shape[0], np.int64)
    for k in range(cl.shape[0]):
        if cl[k] < 0:
            offset[left[k]], offset[right[k]] = offset[k], offset[k] + count[left[k]]
    cluster_order = np.zeros(m, np.int32)
    cluster_order[offset[cl >= 0]] = cl[cl >= 0]
    span = lambda kids: np.stack([offset[kids], offset[kids] + count[kids]], 1)
    walk_span = np.concatenate([
        np.concatenate([span(left[top]), span(right[top])], 1),
        np.stack([kid_a[0::2], kid_b[0::2], kid_a[1::2], kid_b[1::2]], 1),
    ]).astype(np.int32)
    walk_top = n_top
    if n_top == 0 and n_sub == 0:  # one cluster of one leaf: a root above it
        nodes = np.zeros((1, 16), np.int32)
        f = nodes[:, :12].view(np.float32)
        put([0], 0, tree["tree_lo"][:1], tree["tree_hi"][:1], sub_root[:1])
        put([0], 1, tree["tree_lo"][:1], tree["tree_hi"][:1], [~0])
        walk_span, walk_top = np.array([[0, 1, 0, 1]], np.int32), 1
    # the stack holds at most one entry for each inner node above a node: a
    # cluster's depth in the cluster tree, and the levels of its sub-tree (at
    # least one: the root above a lone leaf pushes its other child)
    top_depth = _depth(left, right)
    sub_depth = np.zeros(m, np.int64)
    np.maximum.at(sub_depth, node_cl, node_level + 1)
    stack = max(int((top_depth[cl >= 0] + sub_depth[cl[cl >= 0]]).max()), 1)
    if stack > WALK_STACK_MAX:
        raise ValueError(f"the walk's tree needs a stack of {stack} nodes, more than its "
                         f"traversal stack may hold ({WALK_STACK_MAX})")
    return dict(walk_nodes=nodes, leaf_slot=slots[order].astype(np.int32), walk_stack=stack,
                walk_span=walk_span, walk_top=walk_top, walk_cluster_order=cluster_order)
