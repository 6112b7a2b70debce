"""ReSTIR PT, as the JAX package's ``ops/restir_pt.py``.

The sample of a pixel is a whole path beyond its primary hit, held as its
reconnection vertex x_rc (the prefix's first hit) and a frozen suffix: the
BSDF direction w_s leaving x_rc and the radiance L_s it brings back, folded
by its pdf. A merge at another pixel re-evaluates both pixel-side terms,
f1 * G(x1, x_rc) * [Le_rc + f_rc(-d_rc, w_s) * L_s], so a shift is an exact
reconnection in area measure (Jacobian 1). Where the reconnection is
ill-conditioned at the destination (x_rc too near, or its lobe too smooth),
the replay shift re-samples the first segment at the destination with the
source's random stream (the SRCPIX/SRCSEED rows) and reconnects at the
stored second vertex x3.

Every "closest hit + attributes" query goes through kernel B7
(``accel.intersect.intersect_closest_shaded``): x_rc and x3 of the initial
samples, and one replay trace per merge (temporal and spatial); on a
scene with alpha cutout each of them is the cutout re-trace. The suffix
beyond x3 is path-traced by B6 (``ops.pathtracer.trace``); the shade's
visibility ray is B3. With textures the initial samples fetch the base
colour at x_rc and x3 over their ray cones and path-trace the suffix with
them; the replays of the reuse passes fetch none, as in JAX.

Reservoir rows ([PR.ROWS, N] float32) are the JAX package's. SRCSEED holds
a u32 seed's bits in a float row: it is moved only by selects, gathers and
bit views, never by arithmetic, so a seed whose bits form a NaN survives.
Where the frame passes ``trans``/``coat`` the BSDFs at the primary hit, at
x_rc (from its TRANS/ETA/COATW/COATR rows, eta frozen at the generating
orientation) and at x2' and x3 of the replay take the transmission and
coat lobes, and a glass x_rc may be seen from its back (|cos| at x_rc and
at x2'). The merges rate with the albedo/pi f1 at the primary hit, or with
``full_target`` with its whole BSDF. Reuse gathers move the packed 30-row
form, or with ``packed_reuse=False`` the raw 58 rows.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..accel.intersect import ShadedHit, intersect_closest_shaded, intersect_occluded
from ..accel.megakernel import G, hit_material
from ..core import vec3 as v3
from ..core.rng import uniform4
from ..core.rows import set3, stack_rows
from ..core.vec3 import V3
from ..scene.scene import A
from . import shading_soa as S
from . import sky as SK
from .restir_gi import SKY_DIST
from .gbuffer_pack import temporal_geom_ok
from .pathtracer import trace
from .reservoir_pack import PT_PACKED_ROWS, pack_pt, unpack_pt
from .restir_di import (
    disk_neighbor, geom_ok_slim, geom_table, no_halo, pixel_ids, reproject_prev, take_multi,
)
from .restir_gi import _surf, suppress_outlier_reservoirs

_EPS_RAY = 1e-3


class PR:
    """ReSTIR PT reservoir rows."""

    X = 0  # 3: reconnection vertex position
    N = 3  # 3: normal at rc (faces the prefix side)
    LE = 6  # 3: emitted radiance at rc toward the prefix side
    WS = 9  # 3: suffix direction (unit, world)
    LS = 12  # 3: L_raw * cos_s / pdf_s (frozen suffix radiance)
    BASE = 15  # 3: rc material base color
    METAL = 18
    ROUGH = 19
    WSUM = 20
    M = 21
    W = 22
    PHAT = 23
    DIST = 24  # |x1 - x_rc| at generation (reconnection-validity test)
    SRCPIX = 25  # generating pixel id (exact in f32)
    SRCSEED = 26  # generating frame seed (u32 bits)
    PDFA = 27  # area pdf of x_rc given the generating pixel
    HAS3 = 28  # x3 exists (the suffix hit a surface)
    X3 = 29  # 3: second path vertex
    N3 = 32  # 3
    LE3 = 35  # 3: emission at x3 toward x_rc
    B3 = 38  # 3: x3 material
    M3 = 41
    R3 = 42
    WS3 = 43  # 3: suffix direction at x3
    LS3 = 46  # 3: pdf-folded suffix radiance beyond x3
    PDFS3 = 49  # area pdf of x3 given x_rc
    TRANS = 50  # rc transmission, eta, coat weight and roughness
    ETA = 51
    COATW = 52
    COATR = 53
    TRANS3 = 54  # the same at x3
    ETA3 = 55
    COATW3 = 56
    COATR3 = 57
    ROWS = 58


@dataclass(frozen=True)
class ReSTIRPTConfig:
    """Field names and defaults follow the JAX package."""

    temporal: bool = True
    m_max: float = 10.0  # temporal M cap
    spatial_iterations: int = 1
    spatial_radius: int = 12
    depth_tolerance: float = 0.1
    normal_tolerance: float = 0.9
    min_reconnect_dist: float = 0.05  # relative to the generating connection length
    min_reconnect_rough: float = 0.1  # rc roughness below this -> no reconnection
    replay: bool = True  # replay shift where the reconnection is invalid
    force_replay: bool = False  # testing hook: every merge takes the replay shift
    full_target: bool = False  # True: merges rate with the whole BSDF at the primary hit
    sort_suffix: bool = True  # trace the suffix rays sorted by (material, octant)
    packed_reuse: bool = True  # False: the reuse gathers move raw float32 reservoirs
    spatial_search: int = 1  # neighbours probed for one that passes the geometry test
    boiling_suppression: bool = True


def _rc_mat(res, trans=False, coat=False):
    """The reconnection vertex's material from reservoir rows; ``trans``/
    ``coat`` add its transmission lobe (eta frozen at the generating
    orientation) and its coat."""
    return S.material(v3.from_rows(res, PR.BASE), res[PR.METAL], res[PR.ROUGH],
                      torch.full_like(res[PR.METAL], 1.5), *res[PR.TRANS : PR.COATR + 1], trans,
                      coat)


def _phat_pt(surf, res, full=False, trans=False, coat=False):
    """Target and shading factors of a path sample re-anchored at ``surf``:
    (phat, f1, lout, geom, wi, dist2). phat is the area-measure target
    lum(f1 * L_out) * cos1 * cos_rc / d^2; ``full=False`` takes the albedo/pi
    f1 of the merges, ``full=True`` the BSDF. With ``trans`` x_rc may be
    seen from its back (|cos_rc|)."""
    pos, ns, _ng, wo, mat, frame, _valid = surf
    n_rc = v3.from_rows(res, PR.N)
    to = v3.from_rows(res, PR.X) - pos
    dist2 = torch.clamp_min(v3.dot(to, to), 1e-12)
    wi = to * torch.rsqrt(dist2)
    cos1 = v3.dot(wi, ns)
    cos_rc_raw = -v3.dot(wi, n_rc)
    cos_rc = torch.abs(cos_rc_raw) if trans else torch.clamp_min(cos_rc_raw, 0.0)
    if full:
        f1, _ = S.bsdf_eval(mat, frame.to_local(wo), frame.to_local(wi))
    else:
        inv_pi = 0.3183098861
        f1 = V3((mat.base.x + 0.04) * inv_pi, (mat.base.y + 0.04) * inv_pi,
                (mat.base.z + 0.04) * inv_pi)
    rc_frame = S.make_frame(n_rc)
    f_rc, _ = S.bsdf_eval(_rc_mat(res, trans, coat), rc_frame.to_local(-wi),
                          rc_frame.to_local(v3.from_rows(res, PR.WS)))
    lout = v3.from_rows(res, PR.LE) + f_rc * v3.from_rows(res, PR.LS)
    geom = cos1 * cos_rc / dist2
    phat = torch.clamp_min(v3.luminance(f1 * lout) * geom, 0.0)
    return torch.where(cos1 > 1e-6, phat, 0.0), f1, lout, geom, wi, dist2


def _shift_valid(surf, res, cfg: ReSTIRPTConfig):
    """Reconnection conditions at the destination: x_rc far enough
    (relative to the generating connection length) and its lobe rough
    enough."""
    to = v3.from_rows(res, PR.X) - surf[0]
    dist = torch.sqrt(torch.clamp_min(v3.dot(to, to), 1e-12))
    far_enough = dist > cfg.min_reconnect_dist * torch.clamp_min(res[PR.DIST], 1e-3)
    return far_enough & (res[PR.ROUGH] >= cfg.min_reconnect_rough)


def _sort_perm(keys):
    """Stable ascending permutation and its inverse."""
    perm = torch.argsort(keys, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return perm, inv


def _hit_point(o, d, sh: ShadedHit) -> V3:
    return V3(o[:, 0] + sh.t * d[:, 0], o[:, 1] + sh.t * d[:, 1], o[:, 2] + sh.t * d[:, 2])


def _facing(d: V3, at):
    """(front, geometric normal turned toward the ray's origin)."""
    n_raw = v3.from_rows(at, A.NG)
    front = -v3.dot(d, n_raw) > 0.0
    return front, n_raw * torch.where(front, 1.0, -1.0)


def _pix(n, device):
    return torch.arange(n, dtype=torch.int64, device=device)


def _prefix(surf, pix, seed):
    """The prefix's first segment: a BSDF direction at each primary hit
    (stream 201, salt 0x9717, of pixel ids ``pix`` and seeds ``seed``) from
    the hit offset along its geometric normal. Returns (o [N, 3], d [N, 3],
    wi, pdf_sa, live, wi in the hit's frame)."""
    pos, _ns, ng, wo, mat, frame, valid = surf
    u = uniform4(pix, 201, seed, salt=0x9717)
    wi_l, _, pdf_sa = S.bsdf_sample(mat, frame.to_local(wo), u[0], u[1], u[2])
    wi = frame.to_world(wi_l)
    live = valid & (pdf_sa > 0.0) & (v3.dot(wi, ng) > 1e-6)
    return v3.aos3(pos + ng * _EPS_RAY), v3.aos3(wi), wi, pdf_sa, live, wi_l


def prefix_rays(gbuf, seed: int, trans=False, coat=False, pix0: int = 0):
    """The rays whose closest hits (B7) are the initial samples'
    reconnection vertices: (o [N, 3], d [N, 3]); ``pix0`` as for
    ``initial_samples``."""
    o, d, *_ = _prefix(_surf(gbuf, trans, coat), _pix(gbuf.shape[1], gbuf.device) + pix0, seed)
    return o, d


def _textured_base(textures, sh: ShadedHit, cone, base: V3) -> V3:
    """``base`` at the hits of ``sh`` times their base-colour texture over
    the ray cone's width ``cone``."""
    from ..scene.textures import base_color_at_hits

    f = base_color_at_hits(textures, sh, cone)
    return base if f is None else V3(base.x * f[0], base.y * f[1], base.z * f[2])


def initial_samples(scene, gbuf, pt_cfg, seed: int, cfg: ReSTIRPTConfig, rt: int,
                    light_sets=None, trans=False, coat=False, textures=None,
                    spread_angle=0.0, pix0: int = 0) -> torch.Tensor:
    """One path sample per pixel in a reservoir [PR.ROWS, N].

    Prefix: a BSDF direction at the primary hit, whose closest hit (B7) is
    x_rc; no emission there (the DI pass owns bounce-1 emission). Suffix: a
    BSDF direction at x_rc whose closest hit (B7) is x3, stored explicitly
    for the replay shift, then a BSDF direction at x3 path-traced by B6 with
    ``max_bounces - 3`` further bounces. The suffix rays are traced sorted
    by (rc material, direction octant), so the trace's pixel ids, random
    streams and light sets are the sorted positions, as in the JAX package.
    ``trans``/``coat``: the lobes of the primary hit's and x_rc's materials
    (x3's stays opaque, as in JAX). The sample is rated with the albedo/pi
    f1, or with ``cfg.full_target`` with the whole BSDF. ``textures``: the
    base colour at x_rc over a cone of width (depth + t) * ``spread_angle``,
    at x3 over (depth + t + t3) * ``spread_angle``, and at every vertex of
    the suffix's trace. ``pix0``: the global id of the first pixel (a row
    band's offset): the streams, and the SRCPIX row, take global ids. The
    sorted suffix trace numbers its rays by their place in the band's sort
    from ``pix0``, as the JAX function does, so past ``max_bounces`` = 3 a
    row band draws its suffix's NEE and BSDF samples otherwise than the
    whole image would.
    """
    n = gbuf.shape[1]
    dev = gbuf.device
    surf = _surf(gbuf, trans, coat)
    pos = surf[0]
    pix = _pix(n, dev) + pix0

    # -- prefix: BSDF direction at the primary hit
    o2, d2, wi, pdf_sa, live, _ = _prefix(surf, pix, seed)
    sh = intersect_closest_shaded(scene, o2, d2)
    hit = sh.valid & live
    at = sh.attrs
    x_rc = _hit_point(o2, d2, sh)
    front, n_rc = _facing(wi, at)
    rc_base, rc_metal, rc_rough = v3.from_rows(at, A.BASE), at[A.METAL], at[A.ROUGH]
    if textures:
        rc_base = _textured_base(textures, sh, (gbuf[G.DEPTH] + sh.t) * spread_angle, rc_base)
    rc_ior = torch.clamp_min(at[A.IOR], 1.01)

    # -- suffix: BSDF direction at x_rc; its first hit x3 is resolved here
    rc_mat = hit_material(at, front, trans, coat)._replace(base=rc_base)
    rc_frame = S.make_frame(n_rc)
    u2 = uniform4(pix, 202, seed, salt=0x5F17)
    ws_l, _, pdf_s = S.bsdf_sample(rc_mat, rc_frame.to_local(-wi), u2[0], u2[1], u2[2])
    w_s = rc_frame.to_world(ws_l)
    ws_down = ws_l.z < 0.0
    side_s = v3.dot(w_s, n_rc)
    suffix_ok = hit & (pdf_s > 0.0) & (
        (ws_down & (side_s < -1e-6)) | (~ws_down & (side_s > 1e-6))
    )
    o3 = v3.aos3(x_rc + n_rc * torch.where(ws_down, -_EPS_RAY, _EPS_RAY))
    d3 = v3.aos3(w_s)
    if cfg.sort_suffix:
        octant = (d3[:, 0] > 0).to(torch.int64) + 2 * (d3[:, 1] > 0).to(torch.int64) \
            + 4 * (d3[:, 2] > 0).to(torch.int64)
        perm, inv_perm = _sort_perm(at[A.MATID].to(torch.int64) * 8 + octant)
        sh3 = intersect_closest_shaded(scene, o3[perm], d3[perm])
        sh3 = ShadedHit(sh3.t[inv_perm], sh3.tri[inv_perm], sh3.u[inv_perm], sh3.v[inv_perm],
                        sh3.attrs[:, inv_perm])
    else:
        perm = None
        sh3 = intersect_closest_shaded(scene, o3, d3)
    at3 = sh3.attrs
    has3 = suffix_ok & sh3.valid
    x3 = _hit_point(o3, d3, sh3)
    front3, n3 = _facing(w_s, at3)
    le3_gain = torch.where(has3 & ((at3[A.DOUBLE] > 0.5) | front3), 1.0, 0.0)
    le3 = v3.from_rows(at3, A.EMISS) * le3_gain
    b3, m3, r3 = v3.from_rows(at3, A.BASE), at3[A.METAL], at3[A.ROUGH]
    if textures:
        b3 = _textured_base(textures, sh3, (gbuf[G.DEPTH] + sh.t + sh3.t) * spread_angle, b3)
    ior3 = torch.clamp_min(at3[A.IOR], 1.01)

    # -- suffix continuation at x3 (stream 203) and the radiance beyond it
    mat3 = S.MatSoA(base=b3, metallic=m3, roughness=r3, ior=ior3)
    frame3 = S.make_frame(n3)
    wo3_l = frame3.to_local(-w_s)
    u3 = uniform4(pix, 203, seed, salt=0x3A19)
    ws3_l, _, pdf3 = S.bsdf_sample(mat3, wo3_l, u3[0], u3[1], u3[2])
    ws3 = frame3.to_world(ws3_l)
    suffix3_ok = has3 & (pdf3 > 0.0) & (v3.dot(ws3, n3) > 1e-6)
    o4, d4 = v3.aos3(x3 + n3 * _EPS_RAY), v3.aos3(ws3)
    if pt_cfg.max_bounces >= 3:
        l4_cfg = replace(pt_cfg, max_bounces=pt_cfg.max_bounces - 3, min_emissive_bounce=0,
                         min_nee_bounce=0)
        tex = dict(textures=textures, spread_angle=spread_angle)
        if perm is not None:
            l4 = trace(scene, o4[perm], d4[perm], seed, l4_cfg, rt=rt, light_sets=light_sets,
                       pix0=pix0, **tex)[inv_perm]
        else:
            l4 = trace(scene, o4, d4, seed, l4_cfg, rt=rt, light_sets=light_sets, pix0=pix0,
                       **tex)
    else:
        l4 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    cos3 = torch.clamp_min(v3.dot(ws3, n3), 0.0)
    gain3 = torch.where(suffix3_ok, cos3 / torch.clamp_min(pdf3, 1e-12), 0.0)
    ls3 = V3(l4[:, 0] * gain3, l4[:, 1] * gain3, l4[:, 2] * gain3)

    # L_s at x_rc: (Le3 + f3 * Ls3) folded by the suffix sample's pdf
    f3, _ = S.bsdf_eval(mat3, wo3_l, ws3_l)
    lout3 = le3 + f3 * ls3
    cos_s = torch.abs(v3.dot(w_s, n_rc))
    gain_s = torch.where(suffix_ok, cos_s / torch.clamp_min(pdf_s, 1e-12), 0.0)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    l_s = v3.where(has3, V3(lout3.x * gain_s, lout3.y * gain_s, lout3.z * gain_s),
                   V3(zero, zero, zero))
    le = V3(zero, zero, zero)  # no emission at x_rc: the DI pass owns bounce-1 emission
    if pt_cfg.sky is not None:
        # the suffix's first segment escaped: the sky and the sun disk
        d3v = V3(*d3.T)
        env_s = SK.sky_radiance(d3v, pt_cfg.sky, with_disk=False)
        disk_s = SK.sun_disk(d3, pt_cfg.sky)
        l_sky = V3((env_s.x + disk_s[:, 0]) * gain_s, (env_s.y + disk_s[:, 1]) * gain_s,
                   (env_s.z + disk_s[:, 2]) * gain_s)
        l_s = v3.where(suffix_ok & ~sh3.valid, l_sky, l_s)
        # the prefix escaped: a vertex on the far sphere that emits the sky
        sky_miss = live & ~sh.valid
        d2v = V3(*d2.T)
        x_rc = v3.where(sky_miss, V3(*o2.T) + d2v * SKY_DIST, x_rc)
        n_rc = v3.where(sky_miss, -d2v, n_rc)
        le = v3.where(sky_miss, SK.sky_radiance(d2v, pt_cfg.sky, with_disk=False), le)
        l_s = v3.where(sky_miss, V3(zero, zero, zero), l_s)
        rc_rough = torch.where(sky_miss, 1.0, rc_rough)
        hit = hit | sky_miss

    to = x_rc - pos
    vals = {}
    set3(vals, PR.X, x_rc)
    set3(vals, PR.N, n_rc)
    set3(vals, PR.LE, le)
    set3(vals, PR.WS, w_s)
    set3(vals, PR.LS, l_s)
    set3(vals, PR.BASE, rc_base)
    vals[PR.METAL] = rc_metal
    vals[PR.ROUGH] = rc_rough
    vals[PR.DIST] = torch.sqrt(torch.clamp_min(v3.dot(to, to), 1e-12))
    phat, *_ = _phat_pt(surf, stack_rows(PR.ROWS, vals, n=n), full=cfg.full_target,
                        trans=trans, coat=coat)
    # the source pdf in area measure: the prefix BSDF pdf projected onto x_rc
    dist2 = torch.clamp_min(v3.dot(to, to), 1e-12)
    cos_rc = torch.clamp_min(-v3.dot(to * torch.rsqrt(dist2), n_rc), 1e-6)
    pdf_area = pdf_sa * cos_rc / dist2
    w = torch.where(hit & (pdf_area > 0.0), phat / torch.clamp_min(pdf_area, 1e-12), 0.0)
    vals[PR.WSUM] = w
    vals[PR.M] = hit.to(torch.float32)
    vals[PR.W] = torch.where(phat > 0.0, w / torch.clamp_min(phat, 1e-12), 0.0)
    vals[PR.PHAT] = phat

    # replay identity and the second vertex
    vals[PR.SRCPIX] = pix.to(torch.float32)
    seed_bits = int(seed) & 0xFFFFFFFF
    vals[PR.SRCSEED] = torch.full((n,), seed_bits - (seed_bits >> 31 << 32), dtype=torch.int32,
                                  device=dev).view(torch.float32)
    vals[PR.PDFA] = torch.where(hit, pdf_area, 0.0)
    vals[PR.HAS3] = has3.to(torch.float32)
    set3(vals, PR.X3, x3)
    set3(vals, PR.N3, n3)
    set3(vals, PR.LE3, le3)
    set3(vals, PR.B3, b3)
    vals[PR.M3] = m3
    vals[PR.R3] = r3
    set3(vals, PR.WS3, ws3)
    set3(vals, PR.LS3, ls3)
    # p_A(x3 | x_rc): bridges this sample's pdf-folded suffix to the area
    # convention the replay shift evaluates in (see _merge)
    to23 = x3 - x_rc
    d23_2 = torch.clamp_min(v3.dot(to23, to23), 1e-12)
    cos3_to2 = torch.clamp_min(torch.abs(v3.dot(to23 * torch.rsqrt(d23_2), n3)), 1e-6)
    vals[PR.PDFS3] = torch.where(has3, pdf_s * cos3_to2 / d23_2, 0.0)
    vals[PR.TRANS] = at[A.TRANS]
    vals[PR.ETA] = torch.where(front, 1.0 / rc_ior, rc_ior)
    vals[PR.COATW] = at[A.COATW]
    vals[PR.COATR] = at[A.COATR]
    vals[PR.TRANS3] = at3[A.TRANS]
    vals[PR.ETA3] = torch.where(front3, 1.0 / ior3, ior3)
    vals[PR.COATW3] = at3[A.COATW]
    vals[PR.COATR3] = at3[A.COATR]
    return stack_rows(PR.ROWS, vals, n=n)


def _replay_shift(scene, surf, res_b, cfg: ReSTIRPTConfig, trans=False, coat=False):
    """Replay the candidate's first segment at the destination with its own
    random stream (SRCPIX/SRCSEED), trace it (B7) to x2', and reconnect x2'
    to the stored second vertex x3.

    Returns (phat_b, w_factor, rows_b, ok_b): the area-measure target of the
    replayed path here; the factor of W_b * m_b in the resampling weight,
    J / PDFS3 with J = p_A(x2' | here) / p_A(x2 | source); the replayed
    path's reservoir rows; and where the shift is valid. With ``trans`` a
    glass x2' may reconnect from its back (|cos| toward x3), and x2' and
    x3 take their transmission lobes (x3's ior recovered from |eta3|).
    """
    pos, ns, _ng, wo, mat, frame, _valid = surf
    n = res_b.shape[1]
    o2, d2, wi, pdf_sa, live, wi_l = _prefix(surf, res_b[PR.SRCPIX].to(torch.int64),
                                             res_b[PR.SRCSEED].view(torch.int32))
    live = live & (res_b[PR.HAS3] > 0.5) & (res_b[PR.PDFA] > 0.0)
    sh = intersect_closest_shaded(scene, o2, d2)
    hit = sh.valid & live
    at = sh.attrs
    x2p = _hit_point(o2, d2, sh)
    front2, n2 = _facing(wi, at)

    # reconnection x2' -> x3
    x3, n3 = v3.from_rows(res_b, PR.X3), v3.from_rows(res_b, PR.N3)
    le3, ws3, ls3 = (v3.from_rows(res_b, r) for r in (PR.LE3, PR.WS3, PR.LS3))
    to3 = x3 - x2p
    d23_2 = torch.clamp_min(v3.dot(to3, to3), 1e-12)
    dir23 = to3 * torch.rsqrt(d23_2)
    cos2_raw = v3.dot(dir23, n2)  # at x2' toward x3
    cos2 = torch.abs(cos2_raw) if trans else cos2_raw
    cos3 = torch.clamp_min(-v3.dot(dir23, n3), 0.0)  # at x3 toward x2'
    to_q = x2p - pos
    dq2 = torch.clamp_min(v3.dot(to_q, to_q), 1e-12)
    dist_q = torch.sqrt(dq2)
    far3 = torch.sqrt(d23_2) > cfg.min_reconnect_dist * torch.clamp_min(dist_q, 1e-3)
    ok = (hit & far3 & (at[A.ROUGH] >= cfg.min_reconnect_rough) & (cos2 > 1e-6)
          & (cos3 > 1e-6))

    # BSDF at x2' (in from this pixel, out to x3) and at x3 (in from x2',
    # out along the stored suffix; ior recovered from |eta3|)
    ior2 = torch.clamp_min(at[A.IOR], 1.01)
    mat2 = hit_material(at, front2, trans, coat)
    frame2 = S.make_frame(n2)
    f2, _ = S.bsdf_eval(mat2, frame2.to_local(-wi), frame2.to_local(dir23))
    eta3 = res_b[PR.ETA3]
    ior3 = torch.clamp_min(torch.maximum(eta3, 1.0 / torch.clamp_min(eta3, 1e-3)), 1.01)
    mat3 = S.material(v3.from_rows(res_b, PR.B3), res_b[PR.M3], res_b[PR.R3], ior3,
                      *res_b[PR.TRANS3 : PR.COATR3 + 1], trans, coat)
    frame3 = S.make_frame(n3)
    f3, _ = S.bsdf_eval(mat3, frame3.to_local(-dir23), frame3.to_local(ws3))
    lout3 = le3 + f3 * ls3

    # area-measure target: f1 * f2' * Lout3 * G(q, x2') * G(x2', x3)
    cos1 = v3.dot(wi, ns)
    cos_rc = torch.clamp_min(-v3.dot(wi, n2), 0.0)
    if cfg.full_target:
        f1, _ = S.bsdf_eval(mat, frame.to_local(wo), wi_l)
    else:
        inv_pi = 0.3183098861
        f1 = V3((mat.base.x + 0.04) * inv_pi, (mat.base.y + 0.04) * inv_pi,
                (mat.base.z + 0.04) * inv_pi)
    g_23 = cos2 * cos3 / d23_2
    phat_b = torch.clamp_min(v3.luminance(f1 * f2 * lout3) * (cos1 * cos_rc / dq2) * g_23, 0.0)
    phat_b = torch.where(ok & (cos1 > 1e-6), phat_b, 0.0)

    # weight factor: replay Jacobian times the folded -> area bridge
    pdfa_new = pdf_sa * cos_rc / dq2
    jac = pdfa_new / torch.clamp_min(res_b[PR.PDFA], 1e-20)
    w_factor = torch.where(ok, jac / torch.clamp_min(res_b[PR.PDFS3], 1e-20), 0.0)

    # the replayed path's rows: rc = x2', suffix folded in area measure via
    # x3; LE stays 0 (bounce-1 emission belongs to the DI pass). It keeps the
    # source's replay identity and x3 block, PDFA re-anchored here and PDFS3
    # = 1 (the bridge is consumed), so a later merge may replay it again.
    vals = {}
    set3(vals, PR.X, x2p)
    set3(vals, PR.N, n2)
    set3(vals, PR.WS, dir23)
    set3(vals, PR.LS, lout3 * g_23)
    set3(vals, PR.BASE, mat2.base)
    vals[PR.METAL] = mat2.metallic
    vals[PR.ROUGH] = mat2.roughness
    vals[PR.DIST] = dist_q
    vals[PR.TRANS] = at[A.TRANS]
    vals[PR.ETA] = torch.where(front2, 1.0 / ior2, ior2)
    vals[PR.COATW] = at[A.COATW]
    vals[PR.COATR] = at[A.COATR]
    vals[PR.PDFA] = torch.where(ok, pdfa_new, 0.0)
    vals[PR.PDFS3] = torch.where(ok, 1.0, 0.0)
    vals[PR.HAS3] = ok.to(torch.float32)
    for r in (PR.SRCPIX, PR.SRCSEED, *range(PR.X3, PR.PDFS3), *range(PR.TRANS3, PR.ROWS)):
        vals[r] = res_b[r]
    return phat_b, w_factor, stack_rows(PR.ROWS, vals, n=n), ok


def _merge(res_a, res_b, surf, u, cfg: ReSTIRPTConfig, m_cap=None, scene=None, trans=False,
           coat=False):
    """Combine reservoir B into A with the hybrid shift: reconnection at x_rc
    where its conditions hold here, else (``cfg.replay`` and a ``scene``)
    the replay shift; an invalid shift contributes 0.

    A reconnection take keeps B's rows verbatim: the shift is the identity
    on the path's vertices, so its replay identity, x3 block and densities
    stay the fresh path's. A replay take stores the replayed path's rows.
    """
    valid = surf[6]
    m_b = res_b[PR.M]
    if m_cap is not None:
        m_b = torch.clamp_max(m_b, m_cap)
    phat_b, *_ = _phat_pt(surf, res_b, full=cfg.full_target, trans=trans, coat=coat)
    shift_a = _shift_valid(surf, res_b, cfg)
    if cfg.force_replay:
        shift_a = torch.zeros_like(shift_a)
    phat_b = torch.where(shift_a, phat_b, 0.0)
    w_b = torch.where(valid, phat_b * res_b[PR.W] * m_b, 0.0)
    replay = cfg.replay and scene is not None
    if replay:
        phat_r, w_factor, rows_r, ok_r = _replay_shift(scene, surf, res_b, cfg, trans, coat)
        case_b = ~shift_a & ok_r
        phat_b = torch.where(case_b, phat_r, phat_b)
        w_b = torch.where(case_b & valid, phat_r * res_b[PR.W] * w_factor * m_b, w_b)
    w_sum = res_a[PR.WSUM] + w_b
    take = u * w_sum < w_b
    out = torch.where(take[None, :], res_b, res_a)
    if replay:
        out = torch.where((take & case_b)[None, :], rows_r, out)
    y_phat = torch.where(take, phat_b, res_a[PR.PHAT])
    m_new = res_a[PR.M] + m_b
    big_w = torch.where(y_phat > 0.0, w_sum / torch.clamp_min(m_new * y_phat, 1e-12), 0.0)
    return stack_rows(PR.ROWS, {PR.WSUM: w_sum, PR.M: m_new, PR.W: big_w, PR.PHAT: y_phat},
                      like=out)


def _drop_m_w(res, ok):
    """Zero M and W where reuse is rejected."""
    return stack_rows(PR.ROWS, {PR.M: torch.where(ok, res[PR.M], 0.0),
                                PR.W: torch.where(ok, res[PR.W], 0.0)}, like=res)


def temporal_reuse(res, prev_res, prev_gbuf, gbuf, prev_cam, width, height, seed,
                   cfg: ReSTIRPTConfig, scene=None, prefetch=None, trans=False, coat=False,
                   pos_prev=None, pix=None, prev_row0: int = 0, prev_rows: int | None = None):
    """Merge the reprojected previous-frame reservoirs (M capped at
    ``m_max``; ``scene`` enables the replay shift), then suppress outliers.
    ``prev_gbuf`` is the packed temporal G-buffer; ``pos_prev`` the hit
    points' previous-frame positions (moving geometry); ``prefetch`` = (prev
    reservoirs, prev packed G, inside, depth estimate) when the frame's
    joint gather already fetched them. Row bands: ``pix``, ``prev_row0``
    and ``prev_rows`` as in ``restir_di.temporal_reuse``."""
    surf = _surf(gbuf, trans, coat)
    if prefetch is not None:
        prev_r, prev_g, inside, depth_est = prefetch
    else:
        idx, inside, depth_est = reproject_prev(gbuf, prev_cam, width, height, pos_prev,
                                                prev_row0, prev_rows)
        if cfg.packed_reuse:
            src = prev_res if prev_res.shape[0] == PT_PACKED_ROWS else pack_pt(prev_res)
            prev_p, prev_g = take_multi([src, prev_gbuf], idx)
            prev_r = unpack_pt(prev_p)
        else:
            prev_r, prev_g = take_multi([prev_res, prev_gbuf], idx)
    ok = inside & temporal_geom_ok(prev_g, surf[1], depth_est, cfg.depth_tolerance,
                                   cfg.normal_tolerance)
    u = uniform4(pixel_ids(res.shape[1], res.device, pix), 203, seed, salt=0x4A31)[0]
    out = _merge(res, _drop_m_w(prev_r, ok), surf, u, cfg, m_cap=cfg.m_max, scene=scene,
                 trans=trans, coat=coat)
    if cfg.boiling_suppression:
        out = suppress_outlier_reservoirs(out, w_sum_row=PR.WSUM, m_row=PR.M)
    return out


def spatial_step(res, gbuf, width, height, seed, it, cfg: ReSTIRPTConfig, scene=None,
                 trans=False, coat=False, pix=None, res_src=None, gbuf_src=None,
                 src_row0: int = 0):
    """One spatial-reuse iteration: merge a random neighbour within
    ``spatial_radius`` whose geometry agrees; with ``spatial_search > 1``
    the first of that many probed neighbours that agrees. Row bands:
    ``pix``, ``res_src``, ``gbuf_src`` and ``src_row0`` as in
    ``restir_di.spatial_step``."""
    surf = _surf(gbuf, trans, coat)
    ns = surf[1]
    pix = pixel_ids(res.shape[1], res.device, pix)
    res_src = res if res_src is None else res_src
    gt = geom_table(gbuf if gbuf_src is None else gbuf_src)
    u = uniform4(pix, 204 + it, seed, salt=0x77A1)
    nidx = disk_neighbor(pix, width, height, u, cfg.spatial_radius, src_row0)
    if cfg.spatial_search > 1:
        found = geom_ok_slim(gbuf, gt.index_select(1, nidx), ns, cfg)
        for k in range(1, cfg.spatial_search):
            uk = uniform4(pix, 204 + it, seed, salt=0x77A1 + k * 0x1013)
            cand = disk_neighbor(pix, width, height, uk, cfg.spatial_radius, src_row0)
            ok_k = geom_ok_slim(gbuf, gt.index_select(1, cand), ns, cfg)
            nidx = torch.where(~found & ok_k, cand, nidx)
            found = found | ok_k
    if cfg.packed_reuse:
        nb_p, nb_geom = take_multi([pack_pt(res_src), gt], nidx)
        nb = unpack_pt(nb_p)
    else:
        nb, nb_geom = take_multi([res_src, gt], nidx)
    ok = geom_ok_slim(gbuf, nb_geom, ns, cfg)
    return _merge(res, _drop_m_w(nb, ok), surf, u[2], cfg, scene=scene, trans=trans, coat=coat)


def spatial_reuse(res, gbuf, width, height, seed, cfg: ReSTIRPTConfig, scene=None, trans=False,
                  coat=False, pix=None, ext=no_halo):
    """``cfg.spatial_iterations`` spatial steps; ``pix``, ``ext`` as in
    ``restir_di.spatial_reuse``."""
    gbuf_src, row0 = ext(gbuf, cfg.spatial_radius)
    out = res
    for it in range(cfg.spatial_iterations):
        res_src, _ = ext(out, cfg.spatial_radius)
        out = spatial_step(out, gbuf, width, height, seed, it, cfg, scene=scene, trans=trans,
                           coat=coat, pix=pix, res_src=res_src, gbuf_src=gbuf_src,
                           src_row0=row0)
    return out


def shade(scene, res, gbuf, trans=False, coat=False) -> torch.Tensor:
    """Path radiance of each pixel's surviving sample after the visibility
    ray to x_rc (kernel B3): planar [3, N]."""
    surf = _surf(gbuf, trans, coat)
    pos, _ns, ng, _wo, _mat, _frame, valid = surf
    phat, f1, lout, geom, _wi, _dist2 = _phat_pt(surf, res, full=True, trans=trans, coat=coat)
    big_w = res[PR.W]
    lit = valid & (phat > 0.0) & (big_w > 0.0)
    so = pos + ng * _EPS_RAY
    occ = intersect_occluded(scene, v3.aos3(so), v3.aos3(v3.from_rows(res, PR.X) - so),
                             t_min=1e-3, t_max=1.0 - 1e-3)
    gain = torch.where(lit & ~occ, geom * big_w, 0.0)
    return v3.aos3(f1 * lout * gain, 0)
