"""Any-hit occlusion (kernel B3) and closest hit with attributes (kernel B7).

``occlusion`` replaces the TPU kernel ``_occlusion_kernel``
(the JAX package's ``accel/pallas_kernels.py``, launched by ``occlusion_pallas``)
with ``csrc/occlusion.cu``. Like the G-buffer kernel it is bound by the
per-pair Woop arithmetic, not by bytes: a segment that lets its light
through tests every triangle, a blocked one needs one test. The TPU swept
every ray tile over every triangle chunk. On the card B3 is one call of the
dense sweep's any-hit loop (``csrc/sweep.cuh``, also B6's shadow segment):
the ``num_tris`` real triangles only, triangle-major rows
(``SceneBuffers.woop_rows()``) read as three 16-byte broadcasts, chunks
double-buffered by ``cp.async``, a pair dropped by the signs of its plane
distances before the division (exact for t_min >= 0, which the wrapper
checks); each thread stops at its ray's first hit, a warp whose rays are
all blocked skips a chunk, and a block leaves once all its rays are.

On a clustered scene ``intersect_occluded`` and ``intersect_closest_shaded``
dispatch to the streaming kernels B9 and B8 (``accel.stream``), as the JAX
package's do. On a scene with MASK-mode materials (``scene.has_cutout``)
both run the alpha-cutout re-trace of the JAX package: up to
``CUTOUT_ROUNDS`` closest-hit queries (B7 on a dense scene, B8 on a
clustered one), each testing its hits against the alpha atlas
(``_hit_alpha``) and moving the rays that hit a transparent texel on past
their hit (``_closest_cutout``, ``_occluded_cutout``); a round traces only
the rays still piercing.

Each query counts the rays it hands its kernel in the frame's record
(``utils.stats.FrameStats.count_rays``), once, where it dispatches them:
``occlusion`` (B3), ``_closest_dense`` (B7) and the clustered branches of
``intersect_occluded`` (B9) and ``_closest_raw`` (B8). Parked rays count:
they are launched.

``closest_hit`` replaces ``_closest_kernel`` (``accel/pallas_kernels.py``,
launched by ``closest_hit_pallas``) with ``csrc/closest.cu``: the closest
(t, tri, u, v) of each ray and the winner's attribute row. It is the
port's one "closest hit + attributes" query (``intersect_closest_shaded``),
serving both the JAX package's Pallas path and its pure-XLA dense path
(``intersect_closest_shaded_dense``, which the JAX ReSTIR PT takes on
dense scenes to dodge a TPU fusion problem). Bound: about 40 float
operations per ray-triangle pair against 232 bytes per ray (the ray in,
the hit and its 48-float row out), so arithmetic; at 512^2 rays against
8192 triangles that is about 8.6e10 operations, 1.3 ms at the H100's
67 TFLOP/s of float32, against 0.018 ms for the 61 MB of rays and outputs
at 3.35 TB/s. The kernel streams the triangles through shared memory as
B1 does (one thread per ray) and reads the winner's attribute row by index
after the loop, where the TPU kernel fetched it with a one-hot matmul per
chunk. Measured on an H100 80GB HBM3 (700 W) for 512^2 ReSTIR PT prefix
rays against 8192 triangles: 8.7 ms, 15% of the bound.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import native
from ..scene.scene import A
from ..utils.stats import stats
from .megakernel import (
    INF, TRI_CHUNK, RAY_CHUNK, _check_dense, check_sweep_t_min, closest_hit_plain, dense_rays,
    tri_hits,
)


def occlusion_plain(woop: torch.Tensor, o: torch.Tensor, d: torch.Tensor, t_min, t_max):
    """The plain PyTorch version: bool [N], True where a hit lies in (t_min, t_max)."""
    n = o.shape[0]
    tp = woop.shape[1] // 3
    w3 = woop.reshape(4, 3, tp)
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for r0 in range(0, n, RAY_CHUNK):
        rs = slice(r0, min(n, r0 + RAY_CHUNK))
        for c0 in range(0, tp, TRI_CHUNK):
            t, _, _ = tri_hits(w3[:, :, c0 : c0 + TRI_CHUNK], o[rs], d[rs], t_min, t_max)
            occ[rs] |= (t < INF).any(1)
    return occ


def _check_uncut(scene, name: str, instead: str) -> None:
    """The raw queries test no alpha: a cutout scene ``instead``."""
    if scene.has_cutout:
        raise ValueError(f"{name} tests no alpha and takes scenes without cutout only; "
                         f"a cutout scene {instead}")


def occlusion(scene, o: torch.Tensor, d: torch.Tensor, t_min=1e-4, t_max=INF):
    """Any-hit query of rays or segments o, d [N, 3] in (t_min, t_max)
    against the scene's dense Woop table: bool [N].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    which sweeps the ``scene.num_tris`` real triangles only (the pad slots
    past them are all-zero Woop rows, which never hit) and needs t_min >= 0.
    A clustered scene raises: it takes ``intersect_occluded`` (B9); so does
    a cutout scene, whose any-hit query is the re-trace.
    """
    _check_dense(scene, "occlusion", "takes intersect_occluded (kernel B9)")
    _check_uncut(scene, "occlusion", "takes intersect_occluded (the cutout re-trace)")
    stats.count_rays("B3", o.shape[0])
    if o.device.type == "cpu":
        return occlusion_plain(scene.woop, o, d, t_min, t_max)
    check_sweep_t_min(t_min)
    out = torch.empty((o.shape[0],), dtype=torch.int32, device=o.device)
    launch_occlusion(scene, o, d, t_min, t_max, out)
    return out.bool()


def launch_occlusion(scene, o, d, t_min, t_max, out) -> None:
    """``occlusion``'s launch of B3: into ``out`` int32 [N], 1 where blocked."""
    n, tp = dense_rays(scene, o, d)
    native.require(out, "out", torch.int32, (n,), o.device)
    native.launch("zr_occlusion", o.device, o, d, scene.woop_rows(), out, n, tp, scene.num_tris,
                  float(t_min), float(t_max))


def intersect_occluded(scene, o: torch.Tensor, d: torch.Tensor, t_min=1e-4, t_max=None):
    """Occlusion against the scene's triangles: B9 on a clustered scene
    (``accel.stream``), B3 on a dense one; on a cutout scene the re-trace
    (``_occluded_cutout``)."""
    t_max = INF if t_max is None else t_max
    o, d = o.contiguous(), d.contiguous()
    if scene.has_cutout:
        return _occluded_cutout(scene, o, d, t_min, t_max)
    if scene.cluster_aabb is not None:
        from .stream import occlusion_stream

        stats.count_rays("B9", o.shape[0])
        return occlusion_stream(scene, o, d, t_min, t_max)
    return occlusion(scene, o, d, t_min, t_max)


class ShadedHit(NamedTuple):
    """Closest hit and the winner's attribute row of each ray."""

    t: torch.Tensor  # [N] float32, INF at a miss
    tri: torch.Tensor  # [N] int32, -1 at a miss
    u: torch.Tensor  # [N] float32 barycentric, 0 at a miss
    v: torch.Tensor  # [N]
    attrs: torch.Tensor  # [A.WIDTH, N] rows of scene.A, zeros at a miss

    @property
    def valid(self):
        return self.tri >= 0


def hit_uv(sh: ShadedHit):
    """The texture coordinates (u, v) [N] at each hit, interpolated from
    its attribute rows by its barycentrics (0 at a miss)."""
    at = sh.attrs
    w0 = 1.0 - sh.u - sh.v
    return (w0 * at[A.UV0] + sh.u * at[A.UV1] + sh.v * at[A.UV2],
            w0 * at[A.UV0 + 1] + sh.u * at[A.UV1 + 1] + sh.v * at[A.UV2 + 1])


def tie_chunk(tp: int) -> int:
    """Width of the chunks in which B7 breaks ties, for ``tp`` padded
    triangles: the triangle tile of the JAX kernel (``_pick_tiles``), 512
    for 8192 triangles and 128, 256 or 384 for smaller counts."""
    tc = min(512, tp)
    while tp % tc:
        tc -= TRI_CHUNK
    return tc


def closest_hit_plain_shaded(woop, attrs, o, d, t_min=1e-4, t_max=INF) -> ShadedHit:
    """The plain PyTorch version of the closest-hit kernel (B7)."""
    t, tri, u, v = closest_hit_plain(woop, o, d, t_min, t_max, tie_chunk(woop.shape[1] // 3))
    hit = tri >= 0
    at = torch.where(hit[:, None], attrs[tri.clamp_min(0)], 0.0).T.contiguous()
    return ShadedHit(t, tri.to(torch.int32), u, v, at)


def closest_hit(scene, o, d, t_min=1e-4, t_max=INF) -> ShadedHit:
    """Closest hit of rays o, d [N, 3] over the scene's dense Woop table in
    (t_min, t_max) with the winner's row of ``scene.tri_attrs``, as
    attribute rows [A.WIDTH, N] (the layout every caller reads).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    which sweeps the ``scene.num_tris`` real triangles only (the pad slots
    past them are all-zero Woop rows, which never hit). A clustered scene
    raises: it takes ``intersect_closest_shaded`` (B8); so does a cutout
    scene, whose closest hit is the re-trace.
    """
    _check_dense(scene, "closest_hit", "takes intersect_closest_shaded (kernel B8)")
    _check_uncut(scene, "closest_hit", "takes intersect_closest_shaded (the cutout re-trace)")
    return _closest_dense(scene, o, d, t_min, t_max)


def _closest_dense(scene, o, d, t_min, t_max) -> ShadedHit:
    """``closest_hit`` without the checks of the scene's kind."""
    stats.count_rays("B7", o.shape[0])
    if o.device.type == "cpu":
        return closest_hit_plain_shaded(scene.woop, scene.tri_attrs, o, d, t_min, t_max)
    check_sweep_t_min(t_min)
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    t, u, v = (torch.empty((n,), **f32) for _ in range(3))
    hit = ShadedHit(t, torch.empty((n,), dtype=torch.int32, device=o.device), u, v,
                    torch.empty((A.WIDTH, n), **f32))
    launch_closest(scene, o, d, t_min, t_max, hit)
    return hit


def launch_closest(scene, o, d, t_min, t_max, hit: ShadedHit) -> None:
    """``closest_hit``'s launch of B7: into the tensors of ``hit``."""
    n, tp = dense_rays(scene, o, d)
    native.require(scene.tri_attrs, "tri_attrs", torch.float32, (tp, A.WIDTH), o.device)
    for name in ("t", "u", "v"):
        native.require(getattr(hit, name), name, torch.float32, (n,), o.device)
    native.require(hit.tri, "tri", torch.int32, (n,), o.device)
    native.require(hit.attrs, "attrs", torch.float32, (A.WIDTH, n), o.device)
    native.launch("zr_closest", o.device, o, d, scene.woop_rows(), scene.tri_attrs, *hit, n, tp,
                  scene.num_tris, tie_chunk(tp), float(t_min), float(t_max))


def _closest_raw(scene, o, d, t_min, t_max) -> ShadedHit:
    """The closest hit with attributes, no alpha test: B8 and its
    Moller-Trumbore epilogue on a clustered scene, B7 on a dense one."""
    if scene.cluster_aabb is not None:
        from .stream import closest_hit_stream_shaded

        stats.count_rays("B8", o.shape[0])
        return closest_hit_stream_shaded(scene, o, d, t_min, t_max)
    return _closest_dense(scene, o, d, t_min, t_max)


def intersect_closest_shaded(scene, o: torch.Tensor, d: torch.Tensor, t_min=1e-4,
                             t_max=INF) -> ShadedHit:
    """Closest hit with attributes against the scene's triangles: B8 and
    its Moller-Trumbore epilogue on a clustered scene (``accel.stream``), B7
    on a dense one; on a cutout scene the re-trace (``_closest_cutout``)."""
    o, d = o.contiguous(), d.contiguous()
    if scene.has_cutout:
        return _closest_cutout(scene, o, d, t_min, t_max)
    return _closest_raw(scene, o, d, t_min, t_max)


# ---------------------------------------------------------------------------
# Alpha cutout: the re-trace around the closest-hit queries
# ---------------------------------------------------------------------------

CUTOUT_ROUNDS = 4  # the most transparent layers a query pierces


def _hit_alpha(scene, sh: ShadedHit):
    """(passes [N] bool, has_mask [N] bool) at each hit: the nearest texel
    (wrap addressing) of the hit's atlas layer against its material's
    cutoff; True where the hit has no mask (or no hit)."""
    at = sh.attrs
    u, v = hit_uv(sh)
    cutoff = at[A.ACUT]
    slot = at[A.ATEX].to(torch.int64)
    atlas = scene.alpha_tex
    k, res, _ = atlas.shape
    xi = torch.remainder((u * res).to(torch.int64), res)
    yi = torch.remainder((v * res).to(torch.int64), res)
    alpha = atlas[slot.clamp(0, k - 1), yi, xi]
    has_mask = (cutoff > 0.0) & (slot >= 0)
    return torch.where(has_mask, alpha >= cutoff, True), has_mask


def _step(t):
    """How far a ray moves on past a transparent hit at t."""
    return t + 1e-4 + 1e-4 * t


def _closest_cutout(scene, o, d, t_min, t_max) -> ShadedHit:
    """The closest hit that passes the alpha test: up to CUTOUT_ROUNDS
    closest-hit queries (``_closest_raw``), a ray
    that hit a transparent texel moving on by ``_step`` of its t each time.
    A ray latches its first miss or opaque hit (t the distance from o); one
    still piercing after the last round reports no hit (tri -1, zero
    barycentrics and attributes) at the distance it reached. A round traces
    only the rays still piercing (the JAX loop traces every ray each round
    and keeps the latched ones' results, the same values), and the rounds
    stop once none is: one host synchronisation a round, to count them."""
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    out_t, out_u, out_v = (torch.zeros((n,), **f32) for _ in range(3))
    out_at = torch.zeros((A.WIDTH, n), **f32)
    out_tri = None
    rays = torch.arange(n, device=o.device)  # the rays still piercing
    t_acc = torch.zeros((n,), **f32)
    for _ in range(CUTOUT_ROUNDS):
        sh = _closest_raw(scene, o, d, t_min, t_max)
        if out_tri is None:
            out_tri = torch.full((n,), -1, dtype=sh.tri.dtype, device=o.device)
        passes, _ = _hit_alpha(scene, sh)
        settle = ~sh.valid | passes
        for out, new in ((out_t, t_acc + sh.t), (out_tri, sh.tri), (out_u, sh.u), (out_v, sh.v)):
            out[rays] = torch.where(settle, new, out[rays])
        out_at[:, rays] = torch.where(settle[None, :], sh.attrs, out_at[:, rays])
        keep = (~settle).nonzero().squeeze(1)
        if keep.numel() == 0:
            break
        step = _step(sh.t[keep])
        o = (o[keep] + step[:, None] * d[keep]).contiguous()
        d = d[keep].contiguous()
        t_acc = t_acc[keep] + step
        rays = rays[keep]
    else:
        out_t[rays] = t_acc
    return ShadedHit(out_t, out_tri, out_u, out_v, out_at)


def _occluded_cutout(scene, o, d, t_min, t_max):
    """Occlusion through transparent texels: along each segment, closest
    hits (in (t_min, INF) from the moving origin) until one within t_max of
    o passes the alpha test (occluded) or none lies within it (free). A
    segment still piercing after CUTOUT_ROUNDS counts as occluded. As in
    ``_closest_cutout`` a round traces only the segments still piercing."""
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    rays = torch.arange(o.shape[0], device=o.device)
    t_acc = torch.zeros((o.shape[0],), dtype=torch.float32, device=o.device)
    for _ in range(CUTOUT_ROUNDS):
        sh = _closest_raw(scene, o, d, t_min, INF)
        within = sh.valid & (t_acc + sh.t < t_max)
        passes, _ = _hit_alpha(scene, sh)
        occ[rays] = occ[rays] | (within & passes)
        keep = (within & ~passes).nonzero().squeeze(1)
        if keep.numel() == 0:
            break
        step = _step(sh.t[keep])
        o = (o[keep] + step[:, None] * d[keep]).contiguous()
        d = d[keep].contiguous()
        t_acc = t_acc[keep] + step
        rays = rays[keep]
    else:
        occ[rays] = True  # the layer budget ran out: occluded
    return occ
