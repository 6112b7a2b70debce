"""Refit of an uploaded scene to moved instances, on its device: the JAX
package's ``scene/refit.py`` in torch, plus the walk tree of kernels B8/B9.

``refit_scene(scene, delta_pos, delta_nrm)`` applies each instance's
rest -> now transform (``animation.AnimationRig.deltas``) to every
triangle and recomputes what follows the geometry, as the JAX refit does:
the Woop transforms (a float32 adjugate), the attribute rows NG, N0-N2 and
TANG, the emissive table's V0, E1, E2 and NG, the world bounds over the
real slots and, on a clustered scene, the exact cluster boxes. The
emissive alias table, the areas and powers and the UV-density row stay as
uploaded, which is right for the rigid and uniform-scale motion of glTF
node animation. The alpha atlas (indexed by triangle) does not move.

On a clustered scene the walk tree's boxes are recomputed too, on the
device, over the upload's topology (``leaf_slot``, the refs, the stack
size): each child box is the union of its triangles' (or its clusters')
boxes, padded by ``TREE_PAD_REL`` of the largest coordinate and rounded
outward to float32 exactly as ``accel.bvh.walk_tree`` pads them, so that
B8 and B9 cull with boxes that hold the refit triangles. The spans a
child covers (``SceneBuffers.walk_span``) are contiguous, so every box is
a range minimum and maximum, read from a sparse table in one gather.

The per-triangle transform is plain indexing by ``inst_id`` (-1, a pad
slot, takes the identity row appended at index I). The result is a new
``SceneBuffers``, whose ``woop_rows()`` and ``leaf_rows()`` caches start
empty.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..accel.bvh import TREE_PAD_REL
from .scene import A, EA, SceneBuffers


def _inv3x3(m):
    """Batched 3x3 inverse through the adjugate: m [T, 3, 3] -> [T, 3, 3];
    zero where |det| <= 1e-16, so every ray misses."""
    a = m
    c00 = a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1]
    c01 = -(a[:, 1, 0] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 0])
    c02 = a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0]
    c10 = -(a[:, 0, 1] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 1])
    c11 = a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0]
    c12 = -(a[:, 0, 0] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 0])
    c20 = a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1]
    c21 = -(a[:, 0, 0] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 0])
    c22 = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    det = a[:, 0, 0] * c00 + a[:, 0, 1] * c01 + a[:, 0, 2] * c02
    adj = torch.stack([torch.stack([c00, c10, c20], -1), torch.stack([c01, c11, c21], -1),
                       torch.stack([c02, c12, c22], -1)], 1)
    good = det.abs() > 1e-16
    safe = torch.where(good, det, torch.ones_like(det))
    return torch.where(good[:, None, None], adj / safe[:, None, None], 0.0)


def woop_pack(v0, e1, e2):
    """[T, 3] vertices and edges -> Woop transforms packed [4, 3T], the
    upload's layout (row r of {u, v, w} in columns [r*T, (r+1)*T))."""
    n = torch.linalg.cross(e1, e2)
    inv = _inv3x3(torch.stack([e1, e2, n], -1))
    tw = -torch.einsum("tij,tj->ti", inv, v0)
    w4 = torch.cat([inv, tw[..., None]], -1)  # [T, 3, 4]
    return w4.permute(2, 1, 0).reshape(4, -1)


def _normalize(v):
    return v / torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), 1e-24))


def _outward(x, down: bool):
    """float64 -> float32 rounded toward -inf (``down``) or +inf."""
    y = x.float()
    if down:
        return torch.where(y.double() > x, torch.nextafter(y, torch.full_like(y, -torch.inf)), y)
    return torch.where(y.double() < x, torch.nextafter(y, torch.full_like(y, torch.inf)), y)


def _pad_box(lo, hi, pad):
    """Boxes (float32 or float64) grown by ``pad`` and rounded outward to float32."""
    return _outward(lo.double() - pad, True), _outward(hi.double() + pad, False)


def _sparse_table(lo, hi):
    """Minima of lo and maxima of hi [R, 3] over every run of 2^j rows from
    each row, [J * R, 6] (run j of row i at j * R + i; past the end a run
    holds what rows it has)."""
    r = lo.shape[0]
    levels = [torch.cat([lo, hi], 1)]
    while (1 << len(levels)) <= r:
        prev, h = levels[-1], 1 << (len(levels) - 1)
        nxt = prev.clone()
        nxt[: r - h, :3] = torch.minimum(prev[: r - h, :3], prev[h:, :3])
        nxt[: r - h, 3:] = torch.maximum(prev[: r - h, 3:], prev[h:, 3:])
        levels.append(nxt)
    return torch.cat(levels)


def _range_boxes(table, r: int, a, b):
    """The union of the boxes of rows [a, b) for each span, from the sparse
    table of R = ``r`` rows: two overlapping runs of the largest 2^k <= b - a."""
    a = a.long()
    n = torch.clamp_min(b.long() - a, 1)
    k = torch.floor(torch.log2(n.double())).long()
    k = k - (2**k > n).long() + (2 ** (k + 1) <= n).long()  # exact where log2 rounds
    first, last = table[k * r + a], table[k * r + a + n - 2**k]
    return torch.minimum(first[:, :3], last[:, :3]), torch.maximum(first[:, 3:], last[:, 3:])


def _refit_walk_nodes(scene: SceneBuffers, v0, e1, e2, cluster_aabb) -> torch.Tensor:
    """The walk tree's nodes with every box recomputed from the triangles
    ``v0``/``e1``/``e2`` [Tp, 3] and the cluster boxes ``cluster_aabb``,
    over ``scene``'s topology: the first ``walk_top`` nodes' children
    (the cluster tree's) are their clusters' boxes padded by TREE_PAD_REL of
    the boxes' largest coordinate; the sub-tree nodes' children are their
    rows' triangle boxes (corners summed in float64) padded by TREE_PAD_REL
    of the padded cluster boxes' largest coordinate, both rounded outward,
    as ``accel.bvh.walk_tree`` builds them. Words 12-15 are kept."""
    box = cluster_aabb[:, :6]
    c_lo, c_hi = _pad_box(box[:, :3], box[:, 3:], TREE_PAD_REL * box.abs().max().double())
    pad = TREE_PAD_REL * torch.maximum(c_lo.abs().max(), c_hi.abs().max()).double()
    slot = scene.leaf_slot.long()
    p0 = v0[slot].double()
    p1, p2 = p0 + e1[slot].double(), p0 + e2[slot].double()
    t_lo, t_hi = _pad_box(torch.minimum(torch.minimum(p0, p1), p2),
                          torch.maximum(torch.maximum(p0, p1), p2), pad)
    order = scene.walk_cluster_order.long()
    top, span = scene.walk_top, scene.walk_span
    clusters, rows = _sparse_table(c_lo[order], c_hi[order]), _sparse_table(t_lo, t_hi)
    kids = []
    for side in (0, 1):
        a, b = span[:, 2 * side], span[:, 2 * side + 1]
        lo_c, hi_c = _range_boxes(clusters, order.shape[0], a[:top], b[:top])
        lo_r, hi_r = _range_boxes(rows, slot.shape[0], a[top:], b[top:])
        kids.append((torch.cat([lo_c, lo_r]), torch.cat([hi_c, hi_r])))
    (lo0, hi0), (lo1, hi1) = kids
    words = torch.stack([lo0[:, 0], hi0[:, 0], lo0[:, 1], hi0[:, 1],
                         lo1[:, 0], hi1[:, 0], lo1[:, 1], hi1[:, 1],
                         lo0[:, 2], hi0[:, 2], lo1[:, 2], hi1[:, 2]], 1)
    return torch.cat([words.view(torch.int32), scene.walk_nodes[:, 12:]], 1).contiguous()


def refit_scene(scene: SceneBuffers, delta_pos, delta_nrm) -> SceneBuffers:
    """Apply per-instance rest -> now transforms; returns a new SceneBuffers.

    ``delta_pos`` [I+1, 3, 4] point transforms and ``delta_nrm`` [I+1, 3, 3]
    their inverse transposes (numpy or tensors; row I the identity, for pad
    slots), as ``animation.AnimationRig.deltas`` gives them."""
    dev = scene.device
    delta_pos = torch.as_tensor(delta_pos, dtype=torch.float32, device=dev)
    delta_nrm = torch.as_tensor(delta_nrm, dtype=torch.float32, device=dev)
    n_inst = delta_pos.shape[0]
    idx = torch.where(scene.inst_id < 0, n_inst - 1, scene.inst_id).long()
    rot, tvec, nrm_m = delta_pos[idx, :, :3], delta_pos[idx, :, 3], delta_nrm[idx]

    point = lambda p: torch.einsum("tij,tj->ti", rot, p) + tvec
    direc = lambda d: torch.einsum("tij,tj->ti", rot, d)
    normal = lambda x: _normalize(torch.einsum("tij,tj->ti", nrm_m, x))

    v0, e1, e2 = point(scene.v0), direc(scene.e1), direc(scene.e2)
    ng = _normalize(torch.linalg.cross(e1, e2))
    n0, n1, n2 = normal(scene.n0), normal(scene.n1), normal(scene.n2)
    woop = woop_pack(v0, e1, e2)

    attrs = scene.tri_attrs.clone()
    attrs[:, A.TANG : A.TANG + 3] = _normalize(direc(attrs[:, A.TANG : A.TANG + 3]))
    attrs[:, A.NG : A.NG + 3] = ng
    attrs[:, A.N0 : A.N0 + 3] = n0
    attrs[:, A.N1 : A.N1 + 3] = n1
    attrs[:, A.N2 : A.N2 + 3] = n2

    em = scene.em_attrs.clone()
    etri = torch.clamp_min(scene.em_tri, 0).long()
    emask = (scene.em_tri >= 0).float()[:, None]
    em[:, EA.V0 : EA.V0 + 3] = v0[etri] * emask
    em[:, EA.E1 : EA.E1 + 3] = e1[etri] * emask
    em[:, EA.E2 : EA.E2 + 3] = e2[etri] * emask
    em[:, EA.NG : EA.NG + 3] = ng[etri] * emask

    # world bounds over the real slots (pad slots carry inst_id -1)
    vmask = scene.inst_id >= 0
    big = 3.0e38
    pts = torch.stack([v0, v0 + e1, v0 + e2], 1)  # [Tp, 3, 3]
    lo = torch.where(vmask[:, None, None], pts, big).amin((0, 1))
    hi = torch.where(vmask[:, None, None], pts, -big).amax((0, 1))

    extra = {}
    if scene.cluster_aabb is not None:
        m = scene.cluster_aabb.shape[0]
        c = scene.v0.shape[0] // m
        cpts = pts[: m * c].reshape(m, c * 3, 3)
        cmask = vmask[: m * c].repeat_interleave(3).reshape(m, c * 3)
        clo = torch.where(cmask[..., None], cpts, big).amin(1)
        chi = torch.where(cmask[..., None], cpts, -big).amax(1)
        empty = ~cmask.any(1)  # all pad slots: a box no ray enters
        clo = torch.where(empty[:, None], 0.0, clo)
        chi = torch.where(empty[:, None], -1.0, chi)
        cluster_aabb = scene.cluster_aabb.clone()
        cluster_aabb[:, 0:3], cluster_aabb[:, 3:6] = clo, chi
        extra = dict(cluster_aabb=cluster_aabb,
                     walk_nodes=_refit_walk_nodes(scene, v0, e1, e2, cluster_aabb))

    return replace(scene, woop=woop, tri_attrs=attrs, em_attrs=em, v0=v0, e1=e1, e2=e2, ng=ng,
                   n0=n0, n1=n1, n2=n2, world_lo=lo, world_hi=hi, **extra)
