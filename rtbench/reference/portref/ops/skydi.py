"""SkyDI, as the JAX package's ``ops/skydi.py``: direct sun and sky light
from a per-pixel reservoir over directions toward the sky dome.

Each pixel draws three candidates a round: a point of the sun's cone, a
cosine-hemisphere direction and a BSDF sample, rated with the balance
heuristic over the three source pdfs. Temporal and spatial reuse work as
in ReSTIR DI; a direction means the same at every pixel, so a shift needs
no Jacobian. The shade sends one occlusion segment per pixel toward the
winning direction in (1e-3, 1e8): kernel B3 on a dense scene, B9 on a
clustered one. In the GI and PT frames this replaces the SkyDI-lite term
(``render.frame._sky_direct``).

Reservoir rows ([16, N] float32, the JAX package's layout): 0-2 wi, 3-5
Le(wi) (sky and sun radiance, cached when the candidate is drawn), 9 w_sum,
10 M, 11 W, 13 phat; rows 6-8 and 12 unused. Reuse gathers take the raw
rows (SkyDI has no packed form). Every pass takes ``trans``/``coat``, the
transmission and coat lobes of the primary hits' BSDF.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..accel.intersect import intersect_occluded
from ..accel.megakernel import G
from ..core import vec3 as v3
from ..core.rng import uniform4
from ..core.rows import stack_rows
from ..core.vec3 import V3
from . import shading_soa as S
from . import sky as SK
from .sky import _div
from .gbuffer_pack import temporal_geom_ok
from .restir_di import (
    geom_ok, geom_ok_slim, geom_table, neighbor_pick, no_halo, pixel_ids, surface_from_gbuf,
    take_multi,
)

R_ROWS = 16


@dataclass(frozen=True)
class SkyDIConfig:
    """Field names and defaults follow the JAX package."""

    temporal: bool = True
    m_max: float = 20.0  # temporal M clamp
    spatial_iterations: int = 1
    spatial_radius: int = 16
    depth_tolerance: float = 0.1
    normal_tolerance: float = 0.9
    rounds: int = 1  # (sun, cosine, BSDF) candidate triplets a pixel
    spatial_mis: str = "biased"  # "pairwise": pairwise MIS; anything else the biased merge
    spatial_neighbors: int = 3  # neighbours a pairwise pass


def _sun_basis(sky):
    """The sun direction and two tangents, float32 [3] each (float64 math)."""
    sun = np.asarray(sky.sun_dir, np.float64)
    sun = sun / np.linalg.norm(sun)
    a = np.array([1.0, 0, 0]) if abs(sun[0]) < 0.9 else np.array([0, 1.0, 0])
    t = np.cross(sun, a)
    t /= np.linalg.norm(t)
    b = np.cross(sun, t)
    return [[float(x) for x in v.astype(np.float32)] for v in (sun, t, b)]


def _surf(gbuf, trans=False, coat=False):
    pos, ns, ng, wo, mat, valid = surface_from_gbuf(gbuf, trans, coat)
    frame = S.make_frame(ns)
    return pos, ns, ng, mat, frame, frame.to_local(wo), valid


def _le_dir(wi: V3, sky) -> V3:
    """Sky and sun radiance toward directions wi."""
    env = SK.sky_radiance(wi, sky, with_disk=False)
    disk = SK.sun_disk(v3.aos3(wi), sky).T
    return V3(env.x + disk[0], env.y + disk[1], env.z + disk[2])


def _pdfs(wi: V3, ns: V3, mat, frame, wo_l, sky):
    """The balance heuristic's source pdf of a direction under the three
    strategies."""
    sun, _, _ = _sun_basis(sky)
    cos_r = float(np.cos(sky.sun_angular_radius))
    omega = 2.0 * np.pi * (1.0 - cos_r)
    c_sun = wi.x * sun[0] + wi.y * sun[1] + wi.z * sun[2]
    p_sun = torch.where(c_sun >= cos_r, 1.0 / max(omega, 1e-12), 0.0)
    p_cos = _div(torch.clamp_min(v3.dot(wi, ns), 0.0), math.pi)
    _, p_bsdf = S.bsdf_eval(mat, wo_l, frame.to_local(wi))
    return _div(p_sun + p_cos + p_bsdf, 3.0)


def _phat_dir(wi: V3, le: V3, ns: V3, mat, frame, wo_l):
    cos_s = v3.dot(wi, ns)
    f, _ = S.bsdf_eval(mat, wo_l, frame.to_local(wi))
    lum = v3.luminance(f * le) * torch.clamp_min(cos_s, 0.0)
    return torch.where(cos_s > 1e-6, torch.clamp_min(lum, 0.0), 0.0)


def _stream(res, wi: V3, le: V3, w, phat, u):
    w_sum = res[9] + w
    take = u * torch.clamp_min(w_sum, 1e-30) < w
    pick = lambda a, row: torch.where(take, a, res[row])
    return stack_rows(R_ROWS, {
        0: pick(wi.x, 0), 1: pick(wi.y, 1), 2: pick(wi.z, 2),
        3: pick(le.x, 3), 4: pick(le.y, 4), 5: pick(le.z, 5),
        9: w_sum, 13: pick(phat, 13),
    }, like=res)


def _finalize(res, m):
    phat = res[13]
    big_w = torch.where(phat > 0.0, res[9] / torch.clamp_min(m * phat, 1e-12), 0.0)
    return stack_rows(R_ROWS, {10: m, 11: big_w}, like=res)


def initial_candidates(gbuf, sky, seed: int, cfg: SkyDIConfig, trans=False,
                       coat=False, pix=None) -> torch.Tensor:
    """RIS over sun-cone, cosine and BSDF direction candidates: [16, N].
    Round r draws ``uniform4(pixel, r, seed)`` with salts 0x50D1 (sun cone,
    cosine), 0x50D2 (BSDF) and 0x50D3 (the three stream picks); ``pix``:
    the global pixel ids of a row band."""
    n = gbuf.shape[1]
    _pos, ns, _ng, mat, frame, wo_l, valid = _surf(gbuf, trans, coat)
    ids = pixel_ids(n, gbuf.device, pix)
    sun, t, b = _sun_basis(sky)
    cos_r = float(np.cos(sky.sun_angular_radius))

    res = torch.zeros((R_ROWS, n), dtype=torch.float32, device=gbuf.device)
    m = torch.zeros((n,), dtype=torch.float32, device=gbuf.device)
    for rd in range(cfg.rounds):
        u = uniform4(ids, rd, seed, salt=0x50D1)
        u2 = uniform4(ids, rd, seed, salt=0x50D2)
        u3 = uniform4(ids, rd, seed, salt=0x50D3)
        # a point of the sun's cone (uniform in solid angle)
        cz = 1.0 - u[0] * (1.0 - cos_r)
        sz = torch.sqrt(torch.clamp_min(1.0 - cz * cz, 0.0))
        ph = 2.0 * math.pi * u[1]
        cph, sph = torch.cos(ph), torch.sin(ph)
        wi_s = V3(*(sun[i] * cz + (t[i] * cph + b[i] * sph) * sz for i in range(3)))
        # cosine hemisphere about the shading normal, and a BSDF sample
        wi_c = frame.to_world(S._cosine_hemisphere(u[2], u[3]))
        wi_b_l, _, _ = S.bsdf_sample(mat, wo_l, u2[0], u2[1], u2[2])
        wi_b = frame.to_world(wi_b_l)
        for wi, uu in ((wi_s, u3[0]), (wi_c, u3[1]), (wi_b, u3[2])):
            le = _le_dir(wi, sky)
            phat = _phat_dir(wi, le, ns, mat, frame, wo_l)
            p_src = _pdfs(wi, ns, mat, frame, wo_l, sky)
            ok = valid & (p_src > 1e-12) & (wi.y > -0.999)
            w = torch.where(ok, phat / torch.clamp_min(p_src, 1e-12), 0.0)
            res = _stream(res, wi, le, w, phat, uu)
            m = m + 1.0
    return _finalize(res, m)


def temporal_reuse(res, prev_res, prev_gbuf, gbuf, prev_cam, width: int, height: int,
                   seed: int, cfg: SkyDIConfig, sky, trans=False, coat=False,
                   pos_prev=None, pix=None, prev_row0: int = 0,
                   prev_rows: int | None = None) -> torch.Tensor:
    """Merge the reprojected previous-frame direction reservoir
    (``uniform4(pixel, 0, seed, 0x50D7)``). ``prev_gbuf`` is the previous
    frame's packed temporal G-buffer; ``pos_prev`` [N, 3] the hit points'
    previous-frame positions (moving geometry), by default the current ones.
    Row bands: ``pix``, ``prev_row0`` and ``prev_rows`` as in
    ``restir_di.temporal_reuse``."""
    n = res.shape[1]
    pos, ns, _ng, mat, frame, wo_l, valid = _surf(gbuf, trans, coat)
    p_world = v3.aos3(pos) if pos_prev is None else pos_prev
    px, py, w_fwd = prev_cam.project(p_world, width, height)
    rel = p_world - torch.tensor(np.asarray(prev_cam.eye, np.float32), device=gbuf.device)
    depth_est = torch.sqrt(torch.clamp_min(
        (rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]) + rel[:, 2] * rel[:, 2], 1e-12))
    ix = torch.clamp(torch.round(px).to(torch.int64), 0, width - 1)
    ry = torch.round(py).to(torch.int64)
    rows = height if prev_rows is None else prev_rows
    iy = torch.clamp(ry - prev_row0, 0, rows - 1)
    inside = ((px >= -0.5) & (px <= width - 0.5) & (py >= -0.5) & (py <= height - 0.5)
              & (w_fwd > 0.0) & (ry >= 0) & (ry <= height - 1)
              & (ry - prev_row0 >= 0) & (ry - prev_row0 <= rows - 1))
    nb, nb_g = take_multi([prev_res, prev_gbuf], iy * width + ix)
    ok = inside & valid & temporal_geom_ok(nb_g, ns, depth_est, cfg.depth_tolerance,
                                           cfg.normal_tolerance)
    wi_b, le_b = v3.from_rows(nb, 0), v3.from_rows(nb, 3)
    m_b = torch.where(ok, torch.minimum(nb[10], cfg.m_max * torch.clamp_min(res[10], 1.0)), 0.0)
    phat_b = _phat_dir(wi_b, le_b, ns, mat, frame, wo_l)
    w_b = torch.where(ok, phat_b * nb[11] * m_b, 0.0)
    u = uniform4(pixel_ids(n, res.device, pix), 0, seed, salt=0x50D7)[0]
    return _finalize(_stream(res, wi_b, le_b, w_b, phat_b, u), res[10] + m_b)


def spatial_step(res, gbuf, width: int, height: int, seed: int, it: int,
                 cfg: SkyDIConfig, trans=False, coat=False, pix=None, res_src=None,
                 gbuf_src=None, src_row0: int = 0) -> torch.Tensor:
    """One biased spatial merge (neighbour stream it + 64). Row bands:
    ``pix``, ``res_src``, ``gbuf_src`` and ``src_row0`` as in
    ``restir_di.spatial_step``."""
    n = res.shape[1]
    _pos, ns, _ng, mat, frame, wo_l, valid = _surf(gbuf, trans, coat)
    pix = pixel_ids(n, res.device, pix)
    nidx, u_stream = neighbor_pick(pix, width, height, seed, it + 64, cfg, src_row0)
    nb, nb_geom = take_multi([res if res_src is None else res_src,
                              geom_table(gbuf if gbuf_src is None else gbuf_src)], nidx)
    ok = geom_ok_slim(gbuf, nb_geom, ns, cfg) & valid
    wi_b, le_b = v3.from_rows(nb, 0), v3.from_rows(nb, 3)
    m_b = torch.where(ok, nb[10], 0.0)
    phat_b = _phat_dir(wi_b, le_b, ns, mat, frame, wo_l)
    w_b = torch.where(ok, phat_b * nb[11] * m_b, 0.0)
    return _finalize(_stream(res, wi_b, le_b, w_b, phat_b, u_stream), res[10] + m_b)


def spatial_step_pairwise(res, gbuf, width: int, height: int, seed: int, it: int,
                          cfg: SkyDIConfig, trans=False, coat=False, pix=None, res_src=None,
                          gbuf_src=None, src_row0: int = 0) -> torch.Tensor:
    """One pairwise-MIS spatial pass (neighbour i from stream it*16 + i + 64,
    the canonical pick from ``uniform4(pixel, it*16 + 79, seed, 0x5A73)``),
    as ``ops.restir_di.spatial_step_pairwise`` with the direction target
    (its row-band hooks too)."""
    n = res.shape[1]
    _pos, ns, _ng, mat, frame, wo_l, valid = _surf(gbuf, trans, coat)
    pix = pixel_ids(n, res.device, pix)
    res_src = res if res_src is None else res_src
    gbuf_src = gbuf if gbuf_src is None else gbuf_src
    nbs = []
    k_eff = torch.zeros((n,), dtype=torch.float32, device=res.device)
    for i in range(cfg.spatial_neighbors):
        nidx, u_stream = neighbor_pick(pix, width, height, seed, it * 16 + i + 64, cfg,
                                       src_row0)
        nb, nb_g = take_multi([res_src, gbuf_src], nidx)
        ok = geom_ok(gbuf, nb_g, ns, cfg) & valid
        k_eff = k_eff + ok.to(torch.float32)
        nbs.append((nb, nb_g, ok, u_stream))
    k_div = torch.clamp_min(k_eff, 1.0)

    phat_c_yc, w_c_cap, m_c_count = res[13], res[11], res[10]
    m_c = torch.ones_like(k_eff)
    out = res
    w_sum_s = torch.zeros_like(k_eff)
    m_s = m_c_count
    phat_sel = phat_c_yc
    yc_wi, yc_le = v3.from_rows(res, 0), v3.from_rows(res, 3)
    for nb, nb_g, ok, u_stream in nbs:
        wi_i, le_i = v3.from_rows(nb, 0), v3.from_rows(nb, 3)
        m_i_count = nb[10]
        phat_c_yi = _phat_dir(wi_i, le_i, ns, mat, frame, wo_l)
        num_i = m_i_count * nb[13]
        den_i = num_i + (m_c_count / k_div) * phat_c_yi
        m_i = torch.where(ok & (den_i > 0.0), num_i / torch.clamp_min(den_i, 1e-12), 0.0)
        w_i = m_i * phat_c_yi * nb[11]
        w_sum_s = w_sum_s + w_i
        take = u_stream * torch.clamp_min(w_sum_s, 1e-30) < w_i
        out = torch.where(take[None, :], nb, out)
        phat_sel = torch.where(take, phat_c_yi, phat_sel)

        _pi, ns_i, _ngi, wo_i, mat_i, _vi = surface_from_gbuf(nb_g, trans, coat)
        frame_i = S.make_frame(ns_i)
        phat_i_yc = _phat_dir(yc_wi, yc_le, ns_i, mat_i, frame_i, frame_i.to_local(wo_i))
        num_c = m_i_count * phat_i_yc
        den_c = num_c + (m_c_count / k_div) * phat_c_yc
        dm = torch.where(den_c > 0.0, 1.0 - num_c / torch.clamp_min(den_c, 1e-12), 1.0)
        m_c = m_c + torch.where(ok, dm, 0.0)
        m_s = m_s + torch.where(ok, m_i_count, 0.0)

    w_c = m_c * phat_c_yc * w_c_cap
    w_sum_s = w_sum_s + w_c
    u_end = uniform4(pix, it * 16 + 79, seed, salt=0x5A73)[0]
    take_c = u_end * torch.clamp_min(w_sum_s, 1e-30) < w_c
    out = torch.where(take_c[None, :], res, out)
    phat_sel = torch.where(take_c, phat_c_yc, phat_sel)
    w_new = torch.where(
        phat_sel > 0.0, w_sum_s / torch.clamp_min(phat_sel * (1.0 + k_eff), 1e-12), 0.0
    )
    return stack_rows(R_ROWS, {9: w_sum_s, 10: m_s, 11: w_new, 13: phat_sel}, like=out)


def spatial_reuse(res, gbuf, width: int, height: int, seed: int,
                  cfg: SkyDIConfig, trans=False, coat=False, pix=None,
                  ext=no_halo) -> torch.Tensor:
    """``cfg.spatial_iterations`` spatial passes; ``pix``, ``ext`` as in
    ``restir_di.spatial_reuse``."""
    step = spatial_step_pairwise if cfg.spatial_mis == "pairwise" else spatial_step
    gbuf_src, row0 = ext(gbuf, cfg.spatial_radius)
    out = res
    for it in range(cfg.spatial_iterations):
        res_src, _ = ext(out, cfg.spatial_radius)
        out = step(out, gbuf, width, height, seed, it, cfg, trans, coat, pix, res_src, gbuf_src,
                   row0)
    return out


def shade_segments(res, gbuf):
    """The shade's occlusion segments: origins [N, 3] (the hit moved 1e-3
    along its geometric normal) and the winning unit directions [N, 3],
    tested in (1e-3, 1e8)."""
    pos, ng = v3.from_rows(gbuf, G.POS), v3.from_rows(gbuf, G.NG)
    return v3.aos3(pos + ng * 1e-3), v3.aos3(v3.from_rows(res, 0))


def shade(scene, res, gbuf, trans=False, coat=False) -> torch.Tensor:
    """Direct sky and sun radiance, f * Le * cos * W where the winning
    direction is not blocked: planar [3, N]."""
    _pos, ns, _ng, mat, frame, wo_l, valid = _surf(gbuf, trans, coat)
    wi, le = v3.from_rows(res, 0), v3.from_rows(res, 3)
    cos_s = torch.clamp_min(v3.dot(wi, ns), 0.0)
    f, _ = S.bsdf_eval(mat, wo_l, frame.to_local(wi))
    occ = intersect_occluded(scene, *shade_segments(res, gbuf), t_min=1e-3, t_max=1e8)
    gain = torch.where(valid & ~occ & (res[11] > 0.0), cos_s * res[11], 0.0)
    return v3.aos3(f * le * gain, 0)
