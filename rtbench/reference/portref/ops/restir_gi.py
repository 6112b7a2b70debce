"""ReSTIR GI, as the JAX package's ``ops/restir_gi.py``.

Per pixel the sample is a reconnection vertex: the secondary hit x2 with its
normal n2 and the radiance L2 it sends back toward the primary hit, traced
by the path kernels B4-B6 (``accel.megakernel.trace_with_first_hit``) on a
dense scene and by the wavefront ``ops.pathtracer.trace_reference``
(kernels B8/B9) on a clustered one, and on a scene with alpha cutout (its
queries the cutout re-trace). With ``textures`` the base colour of x2 is
fetched between B4 and B5 (the later bounces untextured, as in JAX), or at
every vertex of the wavefront. With a sky, a ray that escapes becomes
a vertex on a far sphere (``SKY_DIST``) that carries the sky's radiance;
with ``stochastic_multi_bounce`` half the paths from rough primary hits end
at x2. The ReSTIR_GI_LVG variant (``lvg``) moves the NEE at x2 out of the
path trace (bounce 0 runs with ``min_nee_bounce=1``, in kernel B5 on a
dense scene) and draws its light from the light voxel grid
(``_nee_emissive_lvg``, shadow segment B3 or B9).
Reservoir weights use the area measure, so reuse needs no Jacobian.

Reservoir rows ([16, N] float32, the JAX package's layout):
  0-2 x2 | 3-5 n2 | 6-8 L2 | 9 w_sum | 10 M | 11 W | 12 phat | 13-15 pad

Reuse gathers carry GI reservoirs in the packed DI form
(``reservoir_pack.pack_di``), as the JAX package does: L2 travels as f16,
n2 as oct16, and row 12 comes back as the DI two-sided bit, which the merge
then overwrites; with ``packed_reuse=False`` they move the raw float32
rows. The initial samples and the merges rate with the albedo/pi target,
or with ``full_target`` with the whole BSDF; the shade always with the
whole BSDF, its transmission and coat lobes included where the frame
passes ``trans``/``coat``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..accel.intersect import intersect_occluded
from ..accel.megakernel import hit_material, trace_with_first_hit
from ..core import vec3 as v3
from ..core.rng import uniform4
from ..core.rows import stack_rows
from ..core.vec3 import V3
from . import shading_soa as S
from . import sky as SK
from ..scene.scene import A, EA
from .gbuffer_pack import temporal_geom_ok
from .pathtracer import megakernel_eligible, park, trace_reference
from .prelighting import sample_light_points, sample_lvg_at
from .restir_di import (
    disk_neighbor, drop_m_w, gather_reservoirs, geom_ok_slim, geom_table, no_halo, pixel_ids,
    reproject_prev, surface_from_gbuf,
)

R_ROWS = 16
_EPS_RAY = 1e-3
# a ray that escapes into the sky reconnects on a sphere this far out: phat
# ~ 1/d^2 and pdf_area ~ 1/d^2 cancel, and 1e4 stays safe in float32
SKY_DIST = 1.0e4


@dataclass(frozen=True)
class ReSTIRGIConfig:
    """Field names and defaults follow the JAX package."""

    temporal: bool = True
    full_target: bool = False  # True: samples and merges rated with the whole BSDF
    m_max: float = 10.0  # temporal M cap
    spatial_iterations: int = 1
    spatial_radius: int = 12
    depth_tolerance: float = 0.1
    normal_tolerance: float = 0.9
    packed_reuse: bool = True  # False: the reuse gathers move raw float32 reservoirs
    lvg: bool = False  # the NEE at x2 draws its light from the light voxel grid
    boiling_suppression: bool = True


def _surf(gbuf, trans=False, coat=False):
    """[G.ROWS, N] -> (pos, ns, ng, wo, mat, frame, valid); ``trans``/``coat``
    as ``restir_di.surface_from_gbuf``."""
    pos, ns, ng, wo, mat, valid = surface_from_gbuf(gbuf, trans, coat)
    return pos, ns, ng, wo, mat, S.make_frame(ns), valid


def _phat_area(mat, frame, wo_l, pos, ns, x2: V3, n2: V3, l2: V3, full=True):
    """Area-measure target and its factors: (phat, f, geom, wi).
    ``full=False``: the albedo/pi target of candidates and merges."""
    to2 = x2 - pos
    d2 = torch.clamp_min(v3.dot(to2, to2), 1e-12)
    wi = to2 * torch.rsqrt(d2)
    cos1 = v3.dot(wi, ns)
    cos2 = torch.clamp_min(-v3.dot(wi, n2), 0.0)
    if full:
        f, _ = S.bsdf_eval(mat, wo_l, frame.to_local(wi))
    else:
        inv_pi = 0.3183098861
        f = V3((mat.base.x + 0.04) * inv_pi, (mat.base.y + 0.04) * inv_pi,
               (mat.base.z + 0.04) * inv_pi)
    geom = cos1 * cos2 / d2
    phat = torch.clamp_min(v3.luminance(f * l2) * geom, 0.0)
    return torch.where(cos1 > 1e-6, phat, 0.0), f, geom, wi


def secondary_rays(gbuf, seed: int, trans=False, coat=False, pix=None):
    """The rays of the GI samples: a BSDF direction at each primary hit
    (uniforms of bounce 101, salt 0x61AA, of the global pixel ids ``pix``)
    from the hit offset along its geometric normal; a transmitted direction
    is not live. Returns (o [N, 3], d [N, 3], pdf_sa, live)."""
    pos, _ns, ng, wo, mat, frame, valid = _surf(gbuf, trans, coat)
    u = uniform4(pixel_ids(gbuf.shape[1], gbuf.device, pix), 101, seed, salt=0x61AA)
    wi_l, _, pdf_sa = S.bsdf_sample(mat, frame.to_local(wo), u[0], u[1], u[2])
    wi = frame.to_world(wi_l)
    live = valid & (pdf_sa > 0.0) & (v3.dot(wi, ng) > 1e-6)
    return v3.aos3(pos + ng * _EPS_RAY), v3.aos3(wi), pdf_sa, live


def _nee_emissive_lvg(scene, lvg, camera, pos2: V3, ns2: V3, ng2: V3, mat2, wo2: V3, live,
                      seed: int, lvg_cfg, pix) -> V3:
    """NEE at the reconnection vertex x2 with a light from the light voxel
    grid (``sample_lvg_at``, salt 0x6B21), or, where the grid has none, a
    power-sampled light (``uniform4(pixel, 7, seed, 0x6B22)``), weighted by
    the power heuristic against the BSDF, behind one shadow segment.
    ``wo2`` points back toward x1; ``pix``: the global pixel ids (the JAX
    function draws by the band's own pixel index). Returns radiance, zero
    where not ``live``."""
    n = ns2.x.shape[0]
    zero = torch.zeros((n,), dtype=torch.float32, device=ns2.x.device)
    if scene.num_emissives == 0:
        return V3(zero, zero, zero)
    rows_l, use_lvg = sample_lvg_at(lvg, v3.aos3(pos2), live, camera, seed, lvg_cfg,
                                    salt=0x6B21, pix=pix)
    row, lp_f, pdf_f = sample_light_points(scene, uniform4(pix, 7, seed, salt=0x6B22))

    lp = v3.where(use_lvg, v3.from_rows(rows_l, 0), V3(*lp_f.T))
    lng = v3.where(use_lvg, v3.from_rows(rows_l, 3), V3(*row[:, EA.NG : EA.NG + 3].T))
    lle = v3.where(use_lvg, v3.from_rows(rows_l, 6), V3(*row[:, EA.LE : EA.LE + 3].T))
    lpdf = torch.where(use_lvg, rows_l[9], pdf_f)
    two = torch.where(use_lvg, rows_l[10], row[:, EA.TWO_SIDED]) > 0.5

    to_l = lp - pos2
    dist2 = torch.clamp_min(v3.dot(to_l, to_l), 1e-12)
    wi = to_l * torch.rsqrt(dist2)
    cos_s = v3.dot(wi, ns2)
    cos_l_raw = -v3.dot(wi, lng)
    cos_l = torch.where(two, torch.abs(cos_l_raw), cos_l_raw)
    frame2 = S.make_frame(ns2)
    f2, pdf_b = S.bsdf_eval(mat2, frame2.to_local(wo2), frame2.to_local(wi))
    pdf_l_sa = lpdf * dist2 / torch.clamp_min(cos_l, 1e-8)
    cand = live & (cos_s > 1e-6) & (cos_l > 1e-6) & (lpdf > 0.0)
    occ = intersect_occluded(scene, v3.aos3(pos2 + ng2 * _EPS_RAY), v3.aos3(to_l),
                             t_min=1e-3, t_max=1.0 - 1e-3)
    mis = S.power_heuristic(pdf_l_sa, pdf_b)
    gain = torch.where(cand & ~occ, cos_s * mis / torch.clamp_min(pdf_l_sa, 1e-12), 0.0)
    return V3(f2.x * lle.x * gain, f2.y * lle.y * gain, f2.z * lle.z * gain)


def initial_samples(scene, gbuf, pt_cfg, seed: int, rt: int, light_sets=None,
                    spread_angle=0.0, lvg=None, lvg_cam=None, lvg_cfg=None, trans=False,
                    coat=False, full_target=False, textures=None, pix0: int = 0) -> torch.Tensor:
    """One GI sample per pixel: a BSDF direction at the primary hit, traced
    with ``max_bounces - 1`` further bounces (x2's own emission excluded,
    NEE from x2 on). On a clustered scene x2 = o2 + t * d2 from the trace's
    first hit and n2 its geometric normal turned toward the primary hit.
    With ``pt_cfg.sky`` a ray that misses reconnects on the far sphere with
    the sky's radiance (the sun disk excluded: the primary sun NEE owns it).
    With ``pt_cfg.stochastic_multi_bounce`` (and ``max_bounces`` > 1) the
    path of a pixel whose primary roughness is at least 0.1 ends at x2 with
    probability 1/2 (``uniform4(pixel, 97, seed, 0x53B0)``). With ``lvg``
    (the frame's grid, its camera ``lvg_cam`` and ``lvg_cfg``) the NEE at x2
    is ``_nee_emissive_lvg`` in place of the trace's bounce-0 NEE.
    ``trans``/``coat``: the lobes of the primary and x2 materials;
    ``full_target``: the samples are rated with the whole BSDF.
    ``textures``: the bundle of ``scene.textures``; the ray cones start at
    the primary hits with width 0 and widen by ``spread_angle``.
    ``pix0``: the global id of the first pixel (a row band's offset), which
    moves every random stream and the trace's tiles.
    Returns reservoir rows [R_ROWS, N]."""
    pos, ns, _ng, wo, mat, frame, _valid = _surf(gbuf, trans, coat)
    wo_l = frame.to_local(wo)
    pix = torch.arange(gbuf.shape[1], dtype=torch.int64, device=gbuf.device) + pix0
    o2, d2, pdf_sa, live = secondary_rays(gbuf, seed, trans, coat, pix)
    smb_kill = None
    if pt_cfg.stochastic_multi_bounce and pt_cfg.max_bounces > 1:
        smb_kill = (uniform4(pix, 97, seed, salt=0x53B0)[0] < 0.5) & (mat.roughness >= 0.1)

    l2_cfg = replace(
        pt_cfg,
        max_bounces=max(pt_cfg.max_bounces - 1, 0),
        min_emissive_bounce=max(pt_cfg.min_emissive_bounce - 1, 1),
        min_nee_bounce=1 if lvg is not None else 0,
    )
    if megakernel_eligible(scene):
        l2_rows, surf2, alive2 = trace_with_first_hit(
            scene, o2, d2, seed, l2_cfg, rt, light_sets=light_sets, spread_angle=spread_angle,
            smb_kill=smb_kill, textures=textures, pix0=pix0,
        )
        x2_hit = alive2 > 0.5
        x2, n2, l2 = v3.from_rows(surf2, 0), v3.from_rows(surf2, 6), v3.from_rows(l2_rows, 0)
        ns2 = v3.from_rows(surf2, 3)
        mat2 = S.material(v3.from_rows(surf2, 9), *surf2[12:19], trans, coat)
    else:
        # the wavefront trace's bounce-0 closest hit is the x2 query; dead
        # rays are parked so the traversal culls them
        l2_rgb, sh = trace_reference(scene, *park(live, o2, d2), seed, l2_cfg,
                                     return_first_hit=True, smb_kill=smb_kill, textures=textures,
                                     spread_angle=spread_angle, pix0=pix0)
        x2_hit = sh.valid
        x2 = V3(*(o2 + sh.t[:, None] * d2).T)
        n2_raw = v3.from_rows(sh.attrs, A.NG)
        flip = v3.dot(n2_raw, V3(*d2.T)) > 0.0
        n2 = v3.where(flip, -n2_raw, n2_raw)  # faces x1
        l2 = V3(*l2_rgb.T)
        ns2 = n2
        mat2 = hit_material(sh.attrs, ~flip, trans, coat)
    hit = x2_hit & live
    if lvg is not None:
        l2 = l2 + _nee_emissive_lvg(scene, lvg, lvg_cam, x2, ns2, n2, mat2, -V3(*d2.T), hit,
                                    seed, lvg_cfg, pix)
    if pt_cfg.sky is not None:
        sky_miss = live & ~x2_hit
        d2v = V3(*d2.T)
        x2 = v3.where(sky_miss, V3(*o2.T) + d2v * SKY_DIST, x2)
        n2 = v3.where(sky_miss, -d2v, n2)
        l2 = v3.where(sky_miss, SK.sky_radiance(d2v, pt_cfg.sky, with_disk=False), l2)
        hit = hit | sky_miss

    phat, _, _, _ = _phat_area(mat, frame, wo_l, pos, ns, x2, n2, l2, full=full_target)
    to2 = x2 - pos
    dist2 = torch.clamp_min(v3.dot(to2, to2), 1e-12)
    cos2 = torch.clamp_min(-v3.dot(to2 * torch.rsqrt(dist2), n2), 1e-6)
    pdf_area = pdf_sa * cos2 / dist2
    w = torch.where(hit & (pdf_area > 0.0), phat / torch.clamp_min(pdf_area, 1e-12), 0.0)
    big_w = torch.where(phat > 0.0, w / torch.clamp_min(phat, 1e-12), 0.0)
    return stack_rows(R_ROWS, {
        0: x2.x, 1: x2.y, 2: x2.z, 3: n2.x, 4: n2.y, 5: n2.z, 6: l2.x, 7: l2.y, 8: l2.z,
        9: w, 10: hit.to(torch.float32), 11: big_w, 12: phat,
    })


def _merge(res_a, res_b, surf, u, m_cap=None, full=False):
    """Combine reservoir B into A, re-rating B's sample at ``surf`` with
    the albedo/pi target, or with ``full`` the whole BSDF."""
    pos, ns, _ng, wo, mat, frame, valid = surf
    m_b = res_b[10]
    if m_cap is not None:
        m_b = torch.clamp_max(m_b, m_cap)
    phat_b, _, _, _ = _phat_area(
        mat, frame, frame.to_local(wo), pos, ns, v3.from_rows(res_b, 0),
        v3.from_rows(res_b, 3), v3.from_rows(res_b, 6), full=full,
    )
    w_b = torch.where(valid, phat_b * res_b[11] * m_b, 0.0)
    w_sum = res_a[9] + w_b
    take = u * w_sum < w_b
    out = torch.where(take[None, :], res_b, res_a)
    y_phat = torch.where(take, phat_b, res_a[12])
    m_new = res_a[10] + m_b
    big_w = torch.where(y_phat > 0.0, w_sum / torch.clamp_min(m_new * y_phat, 1e-12), 0.0)
    return stack_rows(R_ROWS, {9: w_sum, 10: m_new, 11: big_w, 12: y_phat}, like=out)


def suppress_outlier_reservoirs(res, group: int = 32, w_sum_row: int = 9, m_row: int = 10):
    """Boiling suppression: a reservoir whose w_sum (row ``w_sum_row``)
    exceeds 25x the mean of the rest of its group of ``group`` consecutive
    pixels gets M (row ``m_row``) <= 1."""
    n = res.shape[1]
    g = torch.nn.functional.pad(res[w_sum_row], (0, (-n) % group)).reshape(-1, group)
    avg_others = (g.sum(1, keepdim=True) - g) / (group - 1)
    outlier = (g > 25.0 * avg_others).reshape(-1)[:n]
    return stack_rows(res.shape[0], {
        m_row: torch.where(outlier, torch.clamp_max(res[m_row], 1.0), res[m_row]),
    }, like=res)


def temporal_reuse(res, prev_res, prev_gbuf, gbuf, prev_cam, width, height, seed,
                   cfg: ReSTIRGIConfig, trans=False, coat=False, pos_prev=None, prefetch=None,
                   pix=None, prev_row0: int = 0, prev_rows: int | None = None):
    """Merge the reprojected previous-frame reservoirs into the current ones,
    then suppress outliers. ``prev_gbuf`` is the packed temporal G-buffer;
    ``pos_prev`` the hit points' previous-frame positions (moving geometry);
    ``prefetch`` = (prev reservoirs, prev packed G, inside, depth estimate)
    when the frame's joint gather already fetched them. Row bands: ``pix``,
    ``prev_row0`` and ``prev_rows`` as in ``restir_di.temporal_reuse``."""
    n = res.shape[1]
    surf = _surf(gbuf, trans, coat)
    if prefetch is not None:
        prev_r, prev_g, inside, depth_est = prefetch
    else:
        idx, inside, depth_est = reproject_prev(gbuf, prev_cam, width, height, pos_prev,
                                                prev_row0, prev_rows)
        prev_r, prev_g = gather_reservoirs(prev_res, prev_gbuf, idx, cfg.packed_reuse)
    ok = inside & temporal_geom_ok(prev_g, surf[1], depth_est, cfg.depth_tolerance,
                                   cfg.normal_tolerance)
    prev_r = drop_m_w(prev_r, ok)
    u = uniform4(pixel_ids(n, res.device, pix), 102, seed, salt=0x6E31)[0]
    out = _merge(res, prev_r, surf, u, m_cap=cfg.m_max, full=cfg.full_target)
    return suppress_outlier_reservoirs(out) if cfg.boiling_suppression else out


def spatial_step(res, gbuf, width, height, seed, it, cfg: ReSTIRGIConfig, trans=False,
                 coat=False, pix=None, res_src=None, gbuf_src=None, src_row0: int = 0):
    """One spatial-reuse iteration: merge a random neighbour within
    ``spatial_radius`` whose geometry agrees. Row bands: ``pix``,
    ``res_src``, ``gbuf_src`` and ``src_row0`` as in
    ``restir_di.spatial_step``."""
    n = res.shape[1]
    surf = _surf(gbuf, trans, coat)
    pix = pixel_ids(n, res.device, pix)
    u = uniform4(pix, 103 + it, seed, salt=0x51A7)
    nidx = disk_neighbor(pix, width, height, u, cfg.spatial_radius, src_row0)
    nb, nb_geom = gather_reservoirs(res if res_src is None else res_src,
                                    geom_table(gbuf if gbuf_src is None else gbuf_src), nidx,
                                    cfg.packed_reuse)
    ok = geom_ok_slim(gbuf, nb_geom, surf[1], cfg)
    return _merge(res, drop_m_w(nb, ok), surf, u[2], full=cfg.full_target)


def spatial_reuse(res, gbuf, width, height, seed, cfg: ReSTIRGIConfig, trans=False, coat=False,
                  pix=None, ext=no_halo):
    """``cfg.spatial_iterations`` spatial steps; ``pix``, ``ext`` as in
    ``restir_di.spatial_reuse``."""
    gbuf_src, row0 = ext(gbuf, cfg.spatial_radius)
    out = res
    for it in range(cfg.spatial_iterations):
        res_src, _ = ext(out, cfg.spatial_radius)
        out = spatial_step(out, gbuf, width, height, seed, it, cfg, trans, coat, pix, res_src,
                           gbuf_src, row0)
    return out


def shade(scene, res, gbuf, trans=False, coat=False) -> torch.Tensor:
    """Indirect radiance of each pixel's surviving sample (the whole BSDF)
    after its visibility ray (kernel B3): planar [3, N]."""
    pos, ns, ng, wo, mat, frame, valid = _surf(gbuf, trans, coat)
    x2, l2 = v3.from_rows(res, 0), v3.from_rows(res, 6)
    big_w = res[11]
    phat, f, geom, _ = _phat_area(mat, frame, frame.to_local(wo), pos, ns, x2,
                                  v3.from_rows(res, 3), l2)
    lit = valid & (phat > 0.0) & (big_w > 0.0)
    so = pos + ng * _EPS_RAY
    occ = intersect_occluded(scene, v3.aos3(so), v3.aos3(x2 - so), t_min=1e-3, t_max=1.0 - 1e-3)
    gain = torch.where(lit & ~occ, geom * big_w, 0.0)
    return v3.aos3(f * l2 * gain, 0)
