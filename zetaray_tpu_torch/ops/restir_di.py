"""ReSTIR DI, as the JAX package's ``ops/restir_di.py``.

Reservoir rows ([16, N] float32, the JAX package's layout):
  0-2 y_pos | 3-5 y_ng | 6-8 y_Le | 9 w_sum | 10 M | 11 W
  12 y_two_sided | 13 y_phat (target at this pixel) | 14-15 pad

``initial_candidates`` replaces the TPU kernel ``_ris_kernel``
(the JAX package's ``ops/restir_di.py``) with ``csrc/ris.cu``. A valid pixel
rates all 128 entries of a light set, 32 float operations each (two of them
divisions), an invalid one only the last; the set (8 KB) is shared by a
block and the pixel's G-buffer rows are read once, so the kernel is bound
by instructions, not by bytes. Its design stages the set in
shared memory once per block as 16-byte entry rows, rates each entry once
while keeping the running sum at 8 checkpoints, and rates again only the
chunk of entries that holds the pick, so its outputs equal those of the
sequential sum bit for bit; it computes the pcg4d uniform in the kernel (the
TPU hashed it in XLA beforehand) and replaces the TPU's tril-matmul prefix
sum and one-hot fetch with a running sum and an indexed read.

Everything else here is plain PyTorch: the reuse passes gather reservoirs
with ``index_select`` over the flat pixel axis (the TPU's banded windows
are not needed on the card), in the packed 8-row form
(``packed_reuse=True``, the JAX default) or as the raw float32 rows. The
merges rate a sample with the albedo/pi target or, with ``full_target``,
with the whole BSDF (the transmission and coat lobes included where the
frame passes ``trans``/``coat``); the shade always takes the whole BSDF.
The spatial pass is the biased M-clamped merge
(``spatial_mis="biased"``) or pairwise MIS (``"pairwise"``: ``k`` =
``spatial_neighbors`` defensive strategies a pass, unbiased); with
``lvg_samples`` > 0 each pixel also merges that many candidates from the
light voxel grid (``ops.prelighting``) into its initial reservoir.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..accel.intersect import intersect_occluded
from ..accel.megakernel import G, LSET_ROWS, LSET_STAGED, check_tiles
from ..core import vec3 as v3
from ..core.rng import uniform4
from ..core.rows import stack_rows
from ..core.vec3 import V3
from . import shading_soa as S
from .gbuffer_pack import temporal_geom_ok
from .prelighting import sample_lvg
from .reservoir_pack import DI_PACKED_ROWS, pack_di, unpack_di

R_ROWS = 16
_EPS_RAY = 1e-3
_RIS_BLOCK = 128  # pixels per block of the RIS kernel; divides every tile width


@dataclass(frozen=True)
class ReSTIRConfig:
    """Field names and defaults follow the JAX package."""

    num_candidates: int = 16  # accepted and not read: RIS rates the whole light set, as in JAX
    temporal: bool = True
    m_max_factor: float = 20.0  # clamp temporal M to factor * M of the current reservoir
    spatial_iterations: int = 1
    spatial_radius: int = 16  # pixels
    depth_tolerance: float = 0.1  # relative depth test for reuse
    normal_tolerance: float = 0.9  # min dot(ns, ns_prev) for reuse
    full_target: bool = False  # True: the merges rate with the whole BSDF, not albedo/pi
    lvg_samples: int = 0  # light-voxel-grid candidates merged into each initial reservoir
    spatial_mis: str = "biased"  # "pairwise": pairwise MIS; anything else the biased merge
    spatial_neighbors: int = 3  # neighbours a pairwise pass; read by pairwise MIS only
    packed_reuse: bool = True  # False: the reuse gathers move raw float32 reservoirs


def pixel_ids(n: int, device, pix=None) -> torch.Tensor:
    """The global pixel ids that drive a pass's random streams: ``pix`` (a
    row band's, ``render.frame``), else 0..n-1 (the whole image)."""
    return torch.arange(n, dtype=torch.int64, device=device) if pix is None else pix


def no_halo(x: torch.Tensor, halo: int):
    """The gather source of a whole-image reuse pass: ``x`` itself, whose
    first row is image row 0. A row-sharded frame passes an exchange that
    returns the band extended by ``halo`` rows on both sides and the image
    row of its first row (``render.frame``)."""
    return x, 0


def surface_from_gbuf(gb: torch.Tensor, trans: bool = False, coat: bool = False):
    """[G.ROWS, N] -> (pos, ns, ng, wo, mat, valid). ``trans``/``coat``:
    the material takes the transmission lobe (G.TRANS, G.ETA) and the coat
    (G.COATW, G.COATR); without them those lobes are left out."""
    mat = S.material(v3.from_rows(gb, G.BASE), gb[G.METAL], gb[G.ROUGH], gb[G.IOR],
                     gb[G.TRANS], gb[G.ETA], gb[G.COATW], gb[G.COATR], trans, coat)
    return (
        v3.from_rows(gb, G.POS), v3.from_rows(gb, G.NS), v3.from_rows(gb, G.NG),
        v3.from_rows(gb, G.WO), mat, gb[G.VALID] > 0.5,
    )


def phat(mat, frame, wo_l, pos: V3, ns: V3, y_pos: V3, y_ng: V3, y_le: V3, y_two, full=True):
    """Unshadowed target in area measure: lum(f * Le) * cos_surf * cos_light / d^2.
    Returns (phat, wi_w, dist2, cos_surf, cos_l, f)."""
    to_l = y_pos - pos
    dist2 = torch.clamp_min(v3.dot(to_l, to_l), 1e-12)
    inv_d = torch.rsqrt(dist2)
    wi_w = to_l * inv_d
    cos_surf = v3.dot(wi_w, ns)
    cos_l_raw = -v3.dot(wi_w, y_ng)
    cos_l = torch.where(y_two, torch.abs(cos_l_raw), cos_l_raw)
    if full:
        f, _ = S.bsdf_eval(mat, wo_l, frame.to_local(wi_w))
    else:
        inv_pi = 0.3183098861
        f = V3((mat.base.x + 0.04) * inv_pi, (mat.base.y + 0.04) * inv_pi,
               (mat.base.z + 0.04) * inv_pi)
    lum = v3.luminance(f * y_le) * cos_surf * cos_l / dist2
    ok = (cos_surf > 1e-6) & (cos_l > 1e-6)
    return torch.where(ok, torch.clamp_min(lum, 0.0), 0.0), wi_w, dist2, cos_surf, cos_l, f


# ---------------------------------------------------------------------------
# Initial candidates (kernel B2)
# ---------------------------------------------------------------------------


def initial_candidates_plain(gbuf, light_sets, seed: int, rt: int,
                             pix0: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the RIS kernel: [R_ROWS, N]."""
    n = gbuf.shape[1]
    n_sets, _, ps = light_sets.shape
    dev = gbuf.device
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    set_of_pix = (pix0 // rt + pix // rt) * 31 % n_sets
    rows = {r: light_sets[:, r, :][set_of_pix] for r in range(LSET_STAGED)}  # each [N, ps]
    pos, ns, _ng, _wo, mat, valid = surface_from_gbuf(gbuf)
    col = rows.__getitem__
    e_lum = (0.2126 * col(6) + 0.7152 * col(7)) + 0.0722 * col(8)
    to_x = col(0) - pos.x[:, None]
    to_y = col(1) - pos.y[:, None]
    to_z = col(2) - pos.z[:, None]
    dist2 = torch.clamp_min((to_x * to_x + to_y * to_y) + to_z * to_z, 1e-12)
    inv_d = torch.rsqrt(dist2)
    cos_surf = ((to_x * ns.x[:, None] + to_y * ns.y[:, None]) + to_z * ns.z[:, None]) * inv_d
    cos_l_raw = -((to_x * col(3) + to_y * col(4)) + to_z * col(5)) * inv_d
    cos_l = torch.where(col(10) > 0.5, torch.abs(cos_l_raw), cos_l_raw)
    base_l = (
        (0.2126 * (mat.base.x + 0.04) + 0.7152 * (mat.base.y + 0.04))
        + 0.0722 * (mat.base.z + 0.04)
    ) * 0.3183098861
    phat_all = base_l[:, None] * e_lum * cos_surf * cos_l / dist2
    phat_all = torch.where(
        (cos_surf > 1e-6) & (cos_l > 1e-6), torch.clamp_min(phat_all, 0.0), 0.0
    )
    e_pdf = col(9)
    w_all = torch.where(
        valid[:, None] & (e_pdf > 0.0), phat_all / torch.clamp_min(e_pdf, 1e-12), 0.0
    )
    # sequential inclusive sum, the order the kernel adds in
    cum = torch.empty_like(w_all)
    acc = torch.zeros((n,), dtype=torch.float32, device=dev)
    for k in range(ps):
        acc = acc + w_all[:, k]
        cum[:, k] = acc
    w_sum = acc
    u = uniform4(pix0 + pix, 0, seed, salt=0x51E5)[0]
    sel = cum > (u * w_sum)[:, None]
    idx = torch.where(sel.any(1), sel.to(torch.int64).argmax(1), ps - 1)  # first True
    pick = lambda t: t.gather(1, idx[:, None])[:, 0]
    y_phat = pick(phat_all)
    m_count = float(ps)
    big_w = torch.where(y_phat > 0.0, w_sum / torch.clamp_min(m_count * y_phat, 1e-12), 0.0)
    return stack_rows(R_ROWS, {
        **{k: pick(rows[k]) for k in range(9)},
        9: w_sum, 10: torch.full((n,), m_count, device=dev), 11: big_w,
        12: pick(rows[10]), 13: y_phat,
    })


def initial_candidates(gbuf, light_sets, seed: int, rt: int = 1024, trans: bool = False,
                       coat: bool = False, pix0: int = 0) -> torch.Tensor:
    """Full-set RIS over each pixel's presampled light set -> [R_ROWS, N].

    ``rt`` is the JAX frame's tile width (``render.frame.pick_rt``): pixel p
    draws from set ``(31 * (pix0 // rt + p // rt)) % n_sets`` with the
    uniform of pixel id ``pix0 + p``, where ``pix0`` is the global id of a
    row band's first pixel (0 for the whole image; a multiple of ``rt`` for
    a band to draw as it would in the whole image). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel. Every candidate is
    rated with the albedo/pi target, whatever the material: ``trans`` and
    ``coat`` are taken and not read, as the JAX kernel takes its ``trans``,
    ``coat`` and ``full`` and rates with that target under each.
    """
    if gbuf.device.type == "cpu":
        return initial_candidates_plain(gbuf, light_sets, seed, rt, pix0)
    check_tiles(rt, pix0, _RIS_BLOCK)
    out = torch.empty((R_ROWS, gbuf.shape[1]), dtype=torch.float32, device=gbuf.device)
    launch_ris(gbuf, light_sets, seed, rt, pix0, out)
    return out


def launch_ris(gbuf, light_sets, seed: int, rt: int, pix0: int, out) -> None:
    """``initial_candidates``' launch of B2: into ``out`` [R_ROWS, N], in
    blocks of ``_RIS_BLOCK`` pixels."""
    n = gbuf.shape[1]
    n_sets, _, ps = light_sets.shape
    native.require(gbuf, "gbuf", torch.float32, (G.ROWS, n), gbuf.device)
    native.require(light_sets, "light_sets", torch.float32, (n_sets, LSET_ROWS, ps), gbuf.device)
    native.require(out, "out", torch.float32, (R_ROWS, n), gbuf.device)
    native.launch("zr_ris", gbuf.device, gbuf, light_sets, out, n, n_sets, ps, rt, _RIS_BLOCK,
                  int(seed) & 0xFFFFFFFF, int(pix0))


# ---------------------------------------------------------------------------
# Reservoir merging
# ---------------------------------------------------------------------------


def merge(res_a, res_b, surf, u, m_cap=None, full=False):
    """Combine reservoir B into A, re-rating B's sample at ``surf``
    = (pos, ns, mat, frame, wo_l, valid) with the albedo/pi target (the
    JAX default) or, with ``full`` (``full_target``), the whole BSDF."""
    pos, ns, mat, frame, wo_l, valid = surf
    m_b = res_b[10]
    if m_cap is not None:
        m_b = torch.minimum(m_b, m_cap)
    phat_b, *_ = phat(
        mat, frame, wo_l, pos, ns, v3.from_rows(res_b, 0), v3.from_rows(res_b, 3),
        v3.from_rows(res_b, 6), res_b[12] > 0.5, full=full,
    )
    w_b = torch.where(valid, phat_b * res_b[11] * m_b, 0.0)
    w_sum = res_a[9] + w_b
    take = u * w_sum < w_b
    out = torch.where(take[None, :], res_b, res_a)
    y_phat = torch.where(take, phat_b, res_a[13])
    m_new = res_a[10] + m_b
    big_w = torch.where(y_phat > 0.0, w_sum / torch.clamp_min(m_new * y_phat, 1e-12), 0.0)
    return stack_rows(res_a.shape[0], {9: w_sum, 10: m_new, 11: big_w, 13: y_phat}, like=out)


def _surf(gbuf, trans=False, coat=False):
    pos, ns, _ng, wo, mat, valid = surface_from_gbuf(gbuf, trans, coat)
    frame = S.make_frame(ns)
    return (pos, ns, mat, frame, frame.to_local(wo), valid)


def lvg_merge(res, gbuf, camera, lvg, seed: int, cfg: ReSTIRConfig, lvg_cfg, trans=False,
              coat=False, pix=None):
    """Merge ``cfg.lvg_samples`` light-voxel-grid candidates into each
    pixel's reservoir (``ops.prelighting.sample_lvg`` with salt 0x51AB + s;
    the merge's uniform ``uniform4(pixel, s, seed, 0x1B7A)``; ``pix``: the
    global pixel ids, ``pixel_ids``). A candidate enters as a one-sample
    reservoir, M = 1 and W = 1 / pdf_area, so its merge weight is the RIS
    weight phat / pdf. (The JAX function draws the grid's candidates by
    the band's own pixel index.)"""
    n = res.shape[1]
    surf = _surf(gbuf, trans, coat)
    pix = pixel_ids(n, res.device, pix)
    for s in range(cfg.lvg_samples):
        rows, ok = sample_lvg(lvg, gbuf, camera, seed, lvg_cfg, salt=0x51AB + s, pix=pix)
        okf = ok.to(torch.float32)
        res_b = stack_rows(R_ROWS, {
            **{i: rows[i] for i in range(9)},
            10: okf, 11: okf / torch.clamp_min(rows[9], 1e-9), 12: rows[10],
        }, n=n)
        res = merge(res, res_b, surf, uniform4(pix, s, seed, salt=0x1B7A)[0],
                    full=cfg.full_target)
    return res


def take_multi(parts, idx):
    """Gather several [R_i, N] tables at flat indices ``idx`` with one
    ``index_select``; uint32 parts ride bit-cast as float32."""
    views = [p if p.dtype == torch.float32 else p.view(torch.float32) for p in parts]
    vals = torch.cat(views, 0).index_select(1, idx)
    outs, off = [], 0
    for p in parts:
        o = vals[off : off + p.shape[0]]
        off += p.shape[0]
        outs.append(o if p.dtype == torch.float32 else o.view(p.dtype))
    return outs


def gather_reservoirs(res_src, extra, idx, packed: bool = True):
    """Gather reservoirs together with ``extra`` rows: in the packed 8-row
    form (``packed_reuse=True``, the JAX default; ``res_src`` raw or
    packed) or as the raw float32 rows (``packed=False``)."""
    if not packed:
        return take_multi([res_src, extra], idx)
    src = res_src if res_src.shape[0] == DI_PACKED_ROWS else pack_di(res_src)
    r, e = take_multi([src, extra], idx)
    return unpack_di(r), e


def drop_m_w(res, ok):
    """Zero M and W where reuse is rejected."""
    return stack_rows(res.shape[0], {
        10: torch.where(ok, res[10], 0.0), 11: torch.where(ok, res[11], 0.0),
    }, like=res)


def reproject_prev(gbuf, prev_cam, width: int, height: int, pos_prev=None, prev_row0: int = 0,
                   prev_rows: int | None = None):
    """Previous-frame flat index of each pixel's hit point:
    (idx, inside, depth of the point from the previous eye). ``pos_prev``
    [N, 3]: the hit points' previous-frame positions (moving geometry);
    by default the current ones. ``prev_row0``, ``prev_rows``: the image
    row of the previous tables' first row and their rows (a row band
    extended by its halo); a point beyond them is not inside."""
    p_world = v3.aos3(v3.from_rows(gbuf, G.POS)) if pos_prev is None else pos_prev
    px, py, w_fwd = prev_cam.project(p_world, width, height)
    rel = p_world - torch.tensor(np.asarray(prev_cam.eye, np.float32), device=gbuf.device)
    depth_prev_est = torch.sqrt(torch.clamp_min(
        (rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]) + rel[:, 2] * rel[:, 2], 1e-12
    ))
    ix = torch.clamp(torch.round(px).to(torch.int64), 0, width - 1)
    iy = torch.clamp(torch.round(py).to(torch.int64), 0, height - 1)
    inside = (
        (px >= -0.5) & (px <= width - 0.5) & (py >= -0.5) & (py <= height - 0.5)
        & (w_fwd > 0.0)
    )
    ey = iy - prev_row0
    rows = height if prev_rows is None else prev_rows
    inside = inside & (ey >= 0) & (ey < rows)
    return torch.clamp(ey, 0, rows - 1) * width + ix, inside, depth_prev_est


def temporal_reuse(res, prev_res, prev_gbuf, gbuf, prev_cam, width, height, seed,
                   cfg: ReSTIRConfig, trans=False, coat=False, pos_prev=None, prefetch=None,
                   pix=None, prev_row0: int = 0, prev_rows: int | None = None):
    """Merge the reprojected previous-frame reservoirs into the current ones.

    ``prev_gbuf`` is the previous frame's packed temporal G-buffer (TG);
    ``pos_prev`` the hit points' previous-frame positions (``reproject_prev``);
    ``prefetch`` = (prev reservoirs, prev packed G, inside, depth estimate)
    when the frame's joint gather already fetched them. Row bands: ``pix``
    the global pixel ids (``pixel_ids``); ``prev_row0``, ``prev_rows`` as
    for ``reproject_prev`` (the previous tables halo-extended).
    """
    n = res.shape[1]
    surf = _surf(gbuf, trans, coat)
    ns, valid = surf[1], surf[5]
    if prefetch is not None:
        prev_r, prev_g, inside, depth_prev_est = prefetch
    else:
        idx, inside, depth_prev_est = reproject_prev(gbuf, prev_cam, width, height, pos_prev,
                                                     prev_row0, prev_rows)
        prev_r, prev_g = gather_reservoirs(prev_res, prev_gbuf, idx, cfg.packed_reuse)
    ok = inside & temporal_geom_ok(prev_g, ns, depth_prev_est, cfg.depth_tolerance,
                                   cfg.normal_tolerance) & valid
    prev_r = drop_m_w(prev_r, ok)
    u = uniform4(pixel_ids(n, res.device, pix), 0, seed, salt=0x7E17)[0]
    m_cap = cfg.m_max_factor * torch.clamp_min(res[10], 1.0)
    return merge(res, prev_r, surf, u, m_cap=m_cap, full=cfg.full_target)


GEOM_DEPTH, GEOM_NS, GEOM_VALID = 0, 1, 4


def geom_table(gbuf):
    """[5, N] slim geometry rows (depth, ns.xyz, valid) for the reuse test."""
    return torch.stack(
        [gbuf[G.DEPTH], gbuf[G.NS], gbuf[G.NS + 1], gbuf[G.NS + 2], gbuf[G.VALID]], 0
    )


def geom_ok_slim(gbuf, nb_geom, ns: V3, cfg: ReSTIRConfig):
    depth = gbuf[G.DEPTH]
    ns_nb = V3(nb_geom[GEOM_NS], nb_geom[GEOM_NS + 1], nb_geom[GEOM_NS + 2])
    return (
        (torch.abs(nb_geom[GEOM_DEPTH] - depth)
         < cfg.depth_tolerance * torch.clamp_min(depth, 1e-3))
        & (v3.dot(ns, ns_nb) > cfg.normal_tolerance)
        & (nb_geom[GEOM_VALID] > 0.5)
    )


def disk_neighbor(pix, width, height, u, radius, src_row0: int = 0):
    """Disk-sampled neighbour of each global pixel id ``pix`` from a
    uniform4 row pair, clamped to the image: its flat index in a source
    table whose first row is image row ``src_row0``."""
    x = pix % width
    y = pix // width
    r = radius * torch.sqrt(u[0])
    phi = 2.0 * torch.pi * u[1]
    dx = torch.round(r * torch.cos(phi)).to(torch.int64)
    dy = torch.round(r * torch.sin(phi)).to(torch.int64)
    nx = torch.clamp(x + dx, 0, width - 1)
    ny = torch.clamp(y + dy, 0, height - 1)
    return (ny - src_row0) * width + nx


def spatial_step(res, gbuf, width, height, seed, it, cfg: ReSTIRConfig, trans=False,
                 coat=False, pix=None, res_src=None, gbuf_src=None, src_row0: int = 0):
    """One spatial-reuse iteration (biased M-clamped merge). Row bands:
    ``pix`` the global pixel ids; ``res_src``, ``gbuf_src`` the gather
    sources (the band halo-extended; by default ``res`` and ``gbuf``) and
    ``src_row0`` the image row of their first row."""
    n = res.shape[1]
    surf = _surf(gbuf, trans, coat)
    pix = pixel_ids(n, res.device, pix)
    nidx, u_merge = neighbor_pick(pix, width, height, seed, it, cfg, src_row0)
    nb, nb_geom = gather_reservoirs(res if res_src is None else res_src,
                                    geom_table(gbuf if gbuf_src is None else gbuf_src), nidx,
                                    cfg.packed_reuse)
    ok = geom_ok_slim(gbuf, nb_geom, surf[1], cfg)
    return merge(res, drop_m_w(nb, ok), surf, u_merge, full=cfg.full_target)


def neighbor_pick(pix, width, height, seed, tag: int, cfg, src_row0: int = 0):
    """A random disk neighbour of each pixel (``uniform4(pixel, tag, seed,
    0x5A71)``): (flat index in a source from image row ``src_row0``, the
    uniform of its stream pick)."""
    u = uniform4(pix, tag, seed, salt=0x5A71)
    return disk_neighbor(pix, width, height, u, cfg.spatial_radius, src_row0), u[2]


def geom_ok(gbuf, nb_g, ns: V3, cfg):
    """The neighbour-agreement test against gathered full G-buffer rows."""
    depth = gbuf[G.DEPTH]
    return (
        (torch.abs(nb_g[G.DEPTH] - depth) < cfg.depth_tolerance * torch.clamp_min(depth, 1e-3))
        & (v3.dot(ns, v3.from_rows(nb_g, G.NS)) > cfg.normal_tolerance)
        & (nb_g[G.VALID] > 0.5)
    )


def spatial_step_pairwise(res, gbuf, width, height, seed, it, cfg: ReSTIRConfig, trans=False,
                          coat=False, pix=None, res_src=None, gbuf_src=None,
                          src_row0: int = 0):
    """One pairwise-MIS spatial pass over ``cfg.spatial_neighbors``
    defensive strategies (neighbour i of pass ``it`` from stream it*16 + i).

    A neighbour's sample y_i gets the weight M_i p_i(y_i) / (M_i p_i(y_i) +
    (M_c / k_eff) p_c(y_i)) and the canonical sample collects the
    complements; W divides by 1 + k_eff, where k_eff counts the neighbours
    that pass the geometry test. The samples are area-measure light points,
    so every shift has Jacobian 1. Row bands: ``pix``, ``res_src``,
    ``gbuf_src`` and ``src_row0`` as for ``spatial_step``."""
    n = res.shape[1]
    full = cfg.full_target
    pos, ns, mat, frame, wo_l, valid = _surf(gbuf, trans, coat)
    pix = pixel_ids(n, res.device, pix)
    res_src = res if res_src is None else res_src
    res_src = pack_di(res_src) if cfg.packed_reuse else res_src
    gbuf_src = gbuf if gbuf_src is None else gbuf_src
    nbs = []
    k_eff = torch.zeros((n,), dtype=torch.float32, device=res.device)
    for i in range(cfg.spatial_neighbors):
        nidx, u_stream = neighbor_pick(pix, width, height, seed, it * 16 + i, cfg, src_row0)
        nb, nb_g = take_multi([res_src, gbuf_src], nidx)
        ok = geom_ok(gbuf, nb_g, ns, cfg) & valid
        k_eff = k_eff + ok.to(torch.float32)
        nbs.append((unpack_di(nb) if cfg.packed_reuse else nb, nb_g, ok, u_stream))
    k_div = torch.clamp_min(k_eff, 1.0)

    phat_c_yc, w_c_cap, m_c_count = res[13], res[11], res[10]
    m_c = torch.ones_like(k_eff)
    out = res
    w_sum_s = torch.zeros_like(k_eff)
    m_s = m_c_count
    phat_sel = phat_c_yc
    yc = (v3.from_rows(res, 0), v3.from_rows(res, 3), v3.from_rows(res, 6), res[12] > 0.5)
    for nb, nb_g, ok, u_stream in nbs:
        m_i_count = nb[10]
        # p_c(y_i): the neighbour's sample rated at this pixel's surface
        phat_c_yi, *_ = phat(mat, frame, wo_l, pos, ns, v3.from_rows(nb, 0),
                             v3.from_rows(nb, 3), v3.from_rows(nb, 6), nb[12] > 0.5, full=full)
        num_i = m_i_count * nb[13]
        den_i = num_i + (m_c_count / k_div) * phat_c_yi
        m_i = torch.where(ok & (den_i > 0.0), num_i / torch.clamp_min(den_i, 1e-12), 0.0)
        w_i = m_i * phat_c_yi * nb[11]
        w_sum_s = w_sum_s + w_i
        take = u_stream * torch.clamp_min(w_sum_s, 1e-30) < w_i
        out = torch.where(take[None, :], nb, out)
        phat_sel = torch.where(take, phat_c_yi, phat_sel)

        # p_i(y_c): this pixel's sample rated at the neighbour's surface
        pos_i, ns_i, _ng_i, wo_i, mat_i, _ = surface_from_gbuf(nb_g, trans, coat)
        frame_i = S.make_frame(ns_i)
        phat_i_yc, *_ = phat(mat_i, frame_i, frame_i.to_local(wo_i), pos_i, ns_i, *yc,
                             full=full)
        num_c = m_i_count * phat_i_yc
        den_c = num_c + (m_c_count / k_div) * phat_c_yc
        dm = torch.where(den_c > 0.0, 1.0 - num_c / torch.clamp_min(den_c, 1e-12), 1.0)
        m_c = m_c + torch.where(ok, dm, 0.0)
        m_s = m_s + torch.where(ok, m_i_count, 0.0)

    # the canonical sample's stream
    w_c = m_c * phat_c_yc * w_c_cap
    w_sum_s = w_sum_s + w_c
    u_end = uniform4(pix, it * 16 + 15, seed, salt=0x5A72)[0]
    take_c = u_end * torch.clamp_min(w_sum_s, 1e-30) < w_c
    out = torch.where(take_c[None, :], res, out)
    phat_sel = torch.where(take_c, phat_c_yc, phat_sel)
    w_new = torch.where(
        phat_sel > 0.0, w_sum_s / torch.clamp_min(phat_sel * (1.0 + k_eff), 1e-12), 0.0
    )
    return stack_rows(out.shape[0], {9: w_sum_s, 10: m_s, 11: w_new, 13: phat_sel}, like=out)


def spatial_reuse(res, gbuf, width, height, seed, cfg: ReSTIRConfig, trans=False, coat=False,
                  pix=None, ext=no_halo):
    """Merge reservoirs from random nearby pixels (``cfg.spatial_mis``:
    pairwise MIS or the biased merge). Row bands: ``pix`` the global pixel
    ids, ``ext`` the halo exchange of the gather sources (``no_halo``)."""
    step = spatial_step_pairwise if cfg.spatial_mis == "pairwise" else spatial_step
    gbuf_src, row0 = ext(gbuf, cfg.spatial_radius)
    out = res
    for it in range(cfg.spatial_iterations):
        res_src, _ = ext(out, cfg.spatial_radius)
        out = step(out, gbuf, width, height, seed, it, cfg, trans, coat, pix, res_src, gbuf_src,
                   row0)
    return out


def _shadow_segments(res, gbuf):
    pos = v3.from_rows(gbuf, G.POS)
    ng = v3.from_rows(gbuf, G.NG)
    to_l = v3.from_rows(res, 0) - pos
    return v3.aos3(pos + ng * _EPS_RAY), v3.aos3(to_l)


def visibility_reuse(scene, res, gbuf):
    """Zero w_sum and W where the reservoir's sample is occluded."""
    so, seg = _shadow_segments(res, gbuf)
    occ = intersect_occluded(scene, so, seg, t_min=1e-3, t_max=1.0 - 1e-3)
    keep = ((gbuf[G.VALID] > 0.5) & (res[11] > 0.0) & ~occ).to(torch.float32)
    return stack_rows(res.shape[0], {9: res[9] * keep, 11: res[11] * keep}, like=res)


def shade(scene, res, gbuf, trans=False, coat=False) -> torch.Tensor:
    """Shadow-test each pixel's sample: direct radiance (the whole BSDF)
    plus the directly visible emission, planar [3, N]."""
    pos, ns, mat, frame, wo_l, valid = _surf(gbuf, trans, coat)
    y_le = v3.from_rows(res, 6)
    big_w = res[11]
    ph, _wi, dist2, cos_surf, cos_l, f = phat(
        mat, frame, wo_l, pos, ns, v3.from_rows(res, 0), v3.from_rows(res, 3), y_le,
        res[12] > 0.5,
    )
    lit = valid & (ph > 0.0) & (big_w > 0.0)
    so, seg = _shadow_segments(res, gbuf)
    occ = intersect_occluded(scene, so, seg, t_min=1e-3, t_max=1.0 - 1e-3)
    vis = lit & ~occ
    scale = torch.where(vis, cos_surf * cos_l / torch.clamp_min(dist2, 1e-12) * big_w, 0.0)
    out = f * y_le * scale + v3.from_rows(gbuf, G.EMISS)
    return v3.aos3(out, 0)
