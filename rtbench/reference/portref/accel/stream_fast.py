"""Closest hit and any hit on a clustered scene, with the answers of the
dense plain versions of B8 and B9 (``stream.stream_closest_plain``,
``stream.occlusion_stream_plain``) in a fraction of their time.

The dense versions test every ray against every slot: 2.5 s a launch for
256^2 rays on the 139,266-triangle box, minutes at 1920x1080. Here each
ray first meets the cluster boxes (``scene.cluster_aabb``, padded so that
rounding never drops a cluster that holds a hit), and then tests the slots
of the clusters it enters, nearest box first, with the dense version's
Woop test (``megakernel.tri_hits``, the same operations in the same order,
so each slot's t is the dense version's t). The closest hit keeps the
dense tie rule -- among equal t the lowest cluster, within a cluster the
highest slot -- and stops once the next box lies beyond the best t; the any
hit stops at the first hit. A cluster is skipped only when no slot in it
can change the answer, so the result is the dense version's, bit for bit
(``rtbench/tests/test_rtbench_reference.py`` holds it to that).
"""

from __future__ import annotations

import torch

from .megakernel import INF, tri_hits

BOX_RAYS = 1 << 15  # rays a step of the box test ([rays, clusters, 3] floats)
SLOT_RAYS = 1 << 16  # rays a step of the slot tests ([rays, cluster slots] floats)
RANKS = 16  # candidate clusters a ray takes a pass
# box padding: absolute, as a share of the scene's extent and of the ray
# origin's largest coordinate (the Woop t of a far origin rounds at its scale)
PAD_SCENE = 1e-4
PAD_ORIGIN = 1e-5


def _entries(scene, o, d, t_min, t_max):
    """[R, M] the t at which each ray enters each padded cluster box within
    (t_min, t_max); INF where it does not, -INF where the test is undefined
    (a NaN: the box stays a candidate).

    A ray with a coordinate of its origin or direction that is not finite
    has no candidate: the Woop test gives it an infinite or NaN t, or t = 0,
    for every slot, and no such t lies in (t_min >= 0, t_max), so the dense
    versions never find a hit for it either. (A primary ray that missed the
    scene leaves its "hit point" at INF times its direction.)"""
    box = scene.cluster_aabb
    lo, hi = box[:, 0:3], box[:, 3:6]
    scale = torch.maximum(lo.abs().amax(), hi.abs().amax())
    pad = (PAD_SCENE * (1.0 + scale) + PAD_ORIGIN * o.abs().amax(1, keepdim=True))[:, :, None]
    inv = (1.0 / d)[:, None, :]
    t1 = (lo[None] - pad - o[:, None, :]) * inv
    t2 = (hi[None] + pad - o[:, None, :]) * inv
    near = torch.minimum(t1, t2).amax(2).clamp_min(t_min)
    far = torch.maximum(t1, t2).amin(2).clamp_max(t_max)
    undefined = near.isnan() | far.isnan()
    inside = near <= far
    finite = (torch.isfinite(o).all(1) & torch.isfinite(d).all(1))[:, None]
    return torch.where(finite, torch.where(undefined, -INF, torch.where(inside, near, INF)), INF)


def _candidates(scene, o, d, t_min, t_max, rank0: int):
    """The candidate clusters of ranks [rank0, rank0 + RANKS) of each ray,
    nearest box first: (entry t [R, RANKS], cluster [R, RANKS] int64)."""
    es, cs = [], []
    for r0 in range(0, o.shape[0], BOX_RAYS):
        e = _entries(scene, o[r0 : r0 + BOX_RAYS], d[r0 : r0 + BOX_RAYS], t_min, t_max)
        e, c = e.sort(dim=1, stable=True)
        es.append(e[:, rank0 : rank0 + RANKS])
        cs.append(c[:, rank0 : rank0 + RANKS])
    e, c = torch.cat(es), torch.cat(cs)
    if e.shape[1] < RANKS:  # fewer clusters than RANKS: pad with non-candidates
        fill = RANKS - e.shape[1]
        e = torch.cat([e, e.new_full((e.shape[0], fill), INF)], 1)
        c = torch.cat([c, c.new_zeros((c.shape[0], fill))], 1)
    return e, c


def _slot_tests(scene, cl, o, d, t_min, t_max):
    """The dense Woop test of rays o, d [A, 3] against the slots of their
    clusters cl [A]: t [A, C] (INF where a slot misses)."""
    c = scene.cluster_size
    w = scene.woop.reshape(4, 3, -1, c)[:, :, cl]  # [4, 3, A, C]
    t, _, _ = tri_hits(w, o, d, t_min, t_max)
    return t


def closest(scene, o, d, t_min=1e-4, t_max=INF):
    """B8's answer: (t [N] float32, INF at a miss; slot [N] int32, -1 at a
    miss), equal to ``stream.stream_closest_plain``."""
    n, c = o.shape[0], scene.cluster_size
    dev = o.device
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_c = torch.full((n,), 1 << 62, dtype=torch.int64, device=dev)
    best_s = torch.full((n,), -1, dtype=torch.int64, device=dev)
    ids = torch.arange(n, device=dev)
    rank0 = 0
    col = torch.arange(c, device=dev)
    while ids.numel():
        ent, cls = _candidates(scene, o[ids], d[ids], t_min, t_max, rank0)
        for j in range(RANKS):
            e = ent[:, j]
            act = ((e < INF) & (e <= best_t[ids])).nonzero()[:, 0]
            if act.numel() == 0:
                break
            for a0 in range(0, act.numel(), SLOT_RAYS):
                rows = act[a0 : a0 + SLOT_RAYS]
                r = ids[rows]
                cl = cls[rows, j]
                t = _slot_tests(scene, cl, o[r], d[r], t_min, t_max)
                tmin = t.min(1).values
                idx = torch.where(t == tmin[:, None], col, -1).max(1).values
                bt, bc = best_t[r], best_c[r]
                better = (tmin < INF) & ((tmin < bt) | ((tmin == bt) & (cl < bc)))
                best_t[r] = torch.where(better, tmin, bt)
                best_c[r] = torch.where(better, cl, bc)
                best_s[r] = torch.where(better, cl * c + idx, best_s[r])
        # rays whose last candidate of this pass could still hold a hit take the next ranks
        last = ent[:, RANKS - 1]
        ids = ids[(last < INF) & (last <= best_t[ids])]
        rank0 += RANKS
    return best_t, best_s.to(torch.int32)


def any_hit(scene, o, d, t_min=1e-4, t_max=INF):
    """B9's answer: bool [N], True where a hit lies in (t_min, t_max), equal
    to ``stream.occlusion_stream_plain``."""
    n = o.shape[0]
    dev = o.device
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    ids = torch.arange(n, device=dev)
    rank0 = 0
    while ids.numel():
        ent, cls = _candidates(scene, o[ids], d[ids], t_min, t_max, rank0)
        for j in range(RANKS):
            act = ((ent[:, j] < INF) & ~hit[ids]).nonzero()[:, 0]
            if act.numel() == 0:
                break
            for a0 in range(0, act.numel(), SLOT_RAYS):
                rows = act[a0 : a0 + SLOT_RAYS]
                r = ids[rows]
                t = _slot_tests(scene, cls[rows, j], o[r], d[r], t_min, t_max)
                hit[r] |= (t < INF).any(1)
        ids = ids[(ent[:, RANKS - 1] < INF) & ~hit[ids]]
        rank0 += RANKS
    return hit
