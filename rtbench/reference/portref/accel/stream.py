"""Closest hit (kernel B8) and any hit (kernel B9) on a clustered scene.

The counterpart of the JAX package's ``accel/stream.py``. A clustered scene
(``scene.cluster_aabb`` set; above 8192 triangles by default) keeps its
triangles in BVH-leaf clusters of ``C = scene.cluster_size`` slots, cluster
k owning slots ``[k*C, (k+1)*C)`` of the Woop and attribute tables.

``stream_closest`` replaces ``_closest_stream_kernel`` and
``occlusion_stream`` replaces ``_occlusion_stream_kernel`` with
``csrc/stream.cu``. The TPU kernels swept tiles of shaft-sorted rays over a
front-to-back list of clusters that an interval prepass found to overlap
each tile, in a dynamic grid of visit pairs. On the card each thread walks
one tree for its own ray with a short stack in shared memory, nearer child
first: the tree over the cluster boxes (``accel.bvh.cluster_tree``) with a
sub-tree over each cluster's real slots below it, leaves of a few
triangles (``accel.bvh.walk_tree``), whose Woop rows lie in leaf order,
three 16-byte words a triangle (``SceneBuffers.leaf_rows``), tested with
the dense sweep's sign test. A camera ray of the 139,266-triangle box
reaches about one cluster; below it a walk tests a few leaves, where a walk
over the cluster boxes alone would test all 256 slots of each cluster it
reached, pads included. B8 keeps the closest hit and prunes candidates
beyond it; B9 stops at the segment's first hit.

Bound: one Woop test (about 40 float operations) for each ray that hits
(B8) or is blocked (B9), against the bytes any walk must move: the rays and
the outputs, and for B8 the Woop rows of the distinct slots hit. How many
other rows a walk reads depends on its tree, so they are not counted.

B8 keeps the tie rule of its plain version, the dense brute force with
tie groups of one cluster: among equal t the highest slot within a cluster
and the lowest cluster. The walk visits clusters in its own order, so it
keeps the lexicographic best (t ascending, cluster ascending, slot
descending) and culls a node only when its entry lies strictly beyond the
best t. B9's any hit has no tie rule; it culls only beyond t_max. A
node's slab test never culls a true hit: the
node boxes are padded at build (``bvh.TREE_PAD_REL``), the kernel pads
them again by the same share of the ray origin's largest coordinate, and
widens the slab interval by a relative 1e-6. So the kernels return what
the plain versions return, bit for bit.

The epilogues stay in PyTorch, as in the JAX package: ``closest_hit_stream``
recomputes the winner's Woop (t, u, v), ``closest_hit_stream_shaded`` its
Moller-Trumbore (t, u, v) from ``scene.v0/e1/e2`` and its attribute row.
The JAX package's shaft sort, overlap prepass, visit-pair grid, two-phase
distance cap and stream table layouts are TPU workarounds with no
counterpart here.
"""

from __future__ import annotations

import torch

from .. import native
from . import stream_fast
from ..core import vec3 as v3
from ..core.vec3 import V3
from .intersect import ShadedHit, occlusion_plain
from .megakernel import INF, check_sweep_t_min, closest_hit_plain


def _check_clustered(scene) -> None:
    if scene.cluster_aabb is None:
        raise ValueError("the streaming traversal needs a clustered scene (cluster_aabb)")


def stream_closest_plain(scene, o, d, t_min=1e-4, t_max=INF):
    """The plain PyTorch version of B8: the dense brute force over every
    slot with tie groups of one cluster. (t [N] float32, INF at a miss;
    tri [N] int32 slot, -1 at a miss)."""
    _check_clustered(scene)
    t, tri, _, _ = closest_hit_plain(scene.woop, o, d, t_min, t_max, tie=scene.cluster_size)
    return t, tri.to(torch.int32)


def _check_rays(scene, o, d) -> int:
    """Validate the rays and the Woop table of a launch of B8 or B9; returns N."""
    n = o.shape[0]
    tp = scene.woop.shape[1] // 3
    m = scene.cluster_aabb.shape[0]
    native.require_cuda(o, "o", torch.float32, (n, 3))
    native.require_cuda(d, "d", torch.float32, (n, 3))
    native.require_cuda(scene.woop, "woop", torch.float32, (4, 3 * tp))
    if m * scene.cluster_size != tp:
        raise ValueError(f"{m} clusters of {scene.cluster_size} do not fill {tp} slots")
    return n


def _walk_rows(scene) -> torch.Tensor:
    """Validate the tree of a walk of B8 or B9; returns its leaf-ordered rows."""
    rows = scene.leaf_rows()
    native.require_cuda(scene.walk_nodes, "walk_nodes", torch.int32,
                        (scene.walk_nodes.shape[0], 16))
    native.require_cuda(rows, "leaf_rows", torch.float32, (rows.shape[0], 12))
    return rows


def stream_closest(scene, o, d, t_min=1e-4, t_max=INF):
    """Closest (t, tri) of rays o, d [N, 3] over the clustered scene's slots
    in (t_min, t_max) (B8): t [N] float32 (INF at a miss), tri [N] int32
    slot (-1 at a miss).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    which walks ``scene.walk_nodes`` over ``scene.leaf_rows()`` with a stack
    of ``scene.walk_stack`` entries and needs t_min >= 0.
    """
    _check_clustered(scene)
    if True:  # frozen reference: the plain version on every device
        return stream_fast.closest(scene, o, d, t_min, t_max)
    n = _check_rays(scene, o, d)
    check_sweep_t_min(t_min)
    rows = _walk_rows(scene)
    native.require_cuda(scene.leaf_slot, "leaf_slot", torch.int32, (rows.shape[0],))
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    tri = torch.empty((n,), dtype=torch.int32, device=o.device)
    err = native.lib().zr_stream_closest(
        o.data_ptr(), d.data_ptr(), scene.walk_nodes.data_ptr(), rows.data_ptr(),
        scene.leaf_slot.data_ptr(), t.data_ptr(), tri.data_ptr(), n, scene.cluster_size,
        scene.walk_stack, float(t_min), float(t_max), native.stream_ptr(o.device),
    )
    native.check(err, "stream_closest")
    stream_closest.launches += 1
    return t, tri


stream_closest.launches = 0


def occlusion_stream_plain(scene, o, d, t_min=1e-4, t_max=INF):
    """The plain PyTorch version of B9: the dense any-hit sweep (B3's plain
    version) over every slot."""
    _check_clustered(scene)
    return occlusion_plain(scene.woop, o, d, t_min, t_max)


def occlusion_stream(scene, o, d, t_min=1e-4, t_max=INF):
    """Any-hit query of rays or segments o, d [N, 3] in (t_min, t_max) on
    the clustered scene (B9): bool [N].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    which walks the tree of B8 (``scene.walk_nodes`` over
    ``scene.leaf_rows()``, a stack of ``scene.walk_stack`` entries), stops
    at the first hit and needs t_min >= 0.
    """
    _check_clustered(scene)
    if True:  # frozen reference: the plain version on every device
        return stream_fast.any_hit(scene, o, d, t_min, t_max)
    n = _check_rays(scene, o, d)
    check_sweep_t_min(t_min)
    rows = _walk_rows(scene)
    out = torch.empty((n,), dtype=torch.int32, device=o.device)
    err = native.lib().zr_stream_occlusion(
        o.data_ptr(), d.data_ptr(), scene.walk_nodes.data_ptr(), rows.data_ptr(),
        out.data_ptr(), n, scene.walk_stack, float(t_min), float(t_max),
        native.stream_ptr(o.device),
    )
    native.check(err, "stream_occlusion")
    occlusion_stream.launches += 1
    return out.bool()


occlusion_stream.launches = 0


def _uv_postpass(woop, tri, o, d):
    """The Woop (t, u, v) of each ray's winning slot, in the plain version's
    order of operations (so t is the kernel's t); INF, 0, 0 at a miss."""
    w = woop.reshape(4, 3, -1)[:, :, tri.clamp_min(0).long()]  # [4, 3, N]

    def row(r):
        lo = w[0, r] * o[:, 0] + w[1, r] * o[:, 1] + w[2, r] * o[:, 2] + w[3, r]
        ld = w[0, r] * d[:, 0] + w[1, r] * d[:, 1] + w[2, r] * d[:, 2]
        return lo, ld

    ou, du = row(0)
    ov, dv = row(1)
    ow, dw = row(2)
    t = -ow / torch.where(torch.abs(dw) < 1e-12, 1.0, dw)
    hit = tri >= 0
    return (torch.where(hit, t, INF), torch.where(hit, ou + t * du, 0.0),
            torch.where(hit, ov + t * dv, 0.0))


def _mt_tuv(v0: V3, e1: V3, e2: V3, o: V3, d: V3):
    """Moller-Trumbore (t, u, v) of each ray against its gathered triangle,
    u along e1 and v along e2 as in the Woop test (the JAX ``_mt_tuv``)."""
    pvec = v3.cross(d, e2)
    det = v3.dot(e1, pvec)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    tvec = o - v0
    u = v3.dot(tvec, pvec) * inv
    qvec = v3.cross(tvec, e1)
    v = v3.dot(d, qvec) * inv
    t = v3.dot(e2, qvec) * inv
    return t, u, v


def closest_hit_stream(scene, o, d, t_min=1e-4, t_max=INF):
    """Closest hit on a clustered scene: (t [N], tri [N] int32 slot, u, v),
    the raw-rate query. B8, then the winner's Woop (t, u, v)."""
    o, d = o.contiguous(), d.contiguous()
    _, tri = stream_closest(scene, o, d, t_min, t_max)
    t, u, v = _uv_postpass(scene.woop, tri, o, d)
    return t, tri, u, v


def closest_hit_stream_shaded(scene, o, d, t_min=1e-4, t_max=INF) -> ShadedHit:
    """Closest hit with the winner's attribute row on a clustered scene
    (B8). As in the JAX package, the winner's t, u, v are recomputed by
    Moller-Trumbore from ``scene.v0/e1/e2``; attribute rows [A.WIDTH, N].
    A miss has t INF, tri -1, u = v = 0 and zero rows."""
    o, d = o.contiguous(), d.contiguous()
    _, tri = stream_closest(scene, o, d, t_min, t_max)
    hit = tri >= 0
    idx = tri.clamp_min(0).long()
    t, u, v = _mt_tuv(V3(*scene.v0[idx].T), V3(*scene.e1[idx].T), V3(*scene.e2[idx].T),
                      V3(*o.T), V3(*d.T))
    at = torch.where(hit[:, None], scene.tri_attrs[idx], 0.0).T.contiguous()
    return ShadedHit(torch.where(hit, t, INF), tri, torch.where(hit, u, 0.0),
                     torch.where(hit, v, 0.0), at)
