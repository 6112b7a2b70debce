"""Primary-hit G-buffer (kernel B1), presampled light sets and the path
bounce kernels (B4-B6).

Layouts shared with the JAX package's ``accel/megakernel.py``: the 40-row G-buffer
``G``, the ``[NS, LSET_ROWS, PS]`` light sets, the ``[STATE_ROWS, N]`` path
state and the ``[SURF_ROWS, N]`` surface rows.

``gbuffer`` replaces the TPU kernel ``_gbuffer_kernel``
(the JAX package's ``accel/megakernel.py``, closest hit in ``_closest_soa``) with
``csrc/gbuffer.cu``. On the card it is bound by arithmetic, not bytes: every
ray tests every real triangle (Woop transform, one IEEE division, edge
tests), about 40 float operations per pair, while the rays and the 40
output rows are a few hundred bytes each. The kernel is one call of the
dense sweep of ``csrc/sweep.cuh`` over the ``num_tris`` real triangles of
``SceneBuffers.woop_rows()`` (16-byte broadcasts, a double-buffered ring,
the sign test before the division, candidates beyond the best t dropped
before their edge tests), one thread per ray. The one-hot-matmul attribute
fetch of the TPU is gone: after the sweep each thread reads its winner's
attribute row by index.

The bounce kernels replace ``_bounce_trace_kernel`` (B4),
``_bounce_shade_kernel`` (B5) and ``_bounce_kernel`` (B6) of the JAX
package's ``accel/megakernel.py`` with ``csrc/bounce.cu``, whose three
kernels share the device functions of ``csrc/path.cuh``: B4 is the trace
half (closest hit, MIS-weighted emission, surface rebuild, written out as
the 24 surface rows), B5 the shade half read back from those rows (NEE from
a light set with its shadow ray, BSDF sample, Russian roulette), B6 both
with the surface kept in registers. Like B1 they are bound by the Woop
arithmetic of the two triangle sweeps (closest hit, shadow segment), not by
bytes: a ray's 16 state rows and the light-set entry are read once. All
three sweep the ``num_tris`` real triangles of ``SceneBuffers.woop_rows()``
through ``csrc/sweep.cuh``. A block stages its tile's light set (11 rows)
in shared memory, computes the five pcg4d uniforms of a bounce in place
(the TPU hashed them in XLA beforehand) and reads attribute and light-set
rows by index instead of the TPU's one-hot matmuls; a block leaves a
shadow sweep once every ray in it is occluded or has no candidate. With
``PTConfig.nee_mode="wops"`` B5 and B6 draw each ray's NEE sample from the
emissive alias table instead (``wops_table``: a second pcg4d, salt
``WOPS_SALT``, gives the alias test and the point on the triangle), read
from global memory, its alias entry and then its light's row; the light
sets are not staged.
With ``PTConfig.sky`` set, B4 and B6 add the sky and the sun disk to the
rays that miss, and with ``sun_nee`` B5 and B6 send every ray a second
shadow segment, toward the sun; ``path_regularization`` and
``firefly_clamp`` act in the shade half of B5 and B6. The sky, the sun
and WoPS NEE are compile-time branches of the kernels (their builds without
them carry none of their code); the two other settings are read at run time.
The settings reach a kernel as one block of PATH_OPTS floats
(``path_options``).

On glass and coated materials (``SceneBuffers.has_transmission`` /
``has_coat``) B5 and B6 evaluate and sample the transmission and coat lobes
of ``ops.shading_soa``, as the JAX kernels do under their static
``has_transmission``/``has_coat``: a scene with neither takes the opaque
instances, which carry no code of either lobe; a scene with either takes
the material instances (a compile-time branch of B5 and
B6), which read the two flags at run time (``material_flags``).

A textured trace (``trace_megakernel`` with ``textures``) splits every
bounce as the JAX one does: B4, then ``fetch_base`` in plain PyTorch (the
base colour at each hit times its texture over the ray cone's width, in
the surface rows), then B5; ``trace_with_first_hit`` fetches at bounce 0
only. The bounce kernels test no alpha: a scene with alpha cutout takes
the wavefront ``ops.pathtracer.trace_reference``, and its G-buffer the
cutout re-trace (``accel.intersect``).

Their times on the card, and B1's, are in ``PERF.md`` (section 6).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import vec3 as v3
from ..core.rng import bounce_uniforms, uniform4
from ..core.rows import stack_rows
from ..core.vec3 import V3
from ..ops import shading_soa as S
from ..ops import sky as SK
from ..ops.lights import sample_emissive
from ..core.sampling import square_to_triangle
from ..scene.scene import A, EA
from .. import native

INF = 3.0e38
LSET_ROWS = 16  # 0-2 pos | 3-5 ng | 6-8 Le | 9 pdf_area | 10 two_sided
LSET_STAGED = 11  # rows 0-10: what the kernels read of a set (staged in shared memory)
PS = 128  # presampled light samples per set
NS = 64  # number of presampled sets
TRI_CHUNK = 128  # triangle chunk of the closest-hit tie rule
RAY_CHUNK = 1 << 16  # rays per step of the plain version (bounds its memory)
STATE_ROWS = 16  # 0-2 o | 3-5 d | 6-8 throughput | 9-11 radiance | 12 prev_bsdf_pdf
# | 13 alive | 14 specular-bounce flag | 15 accumulated ray-cone width
SURF_ROWS = 24  # 0-2 pos | 3-5 ns | 6-8 ng | 9-11 base | 12 metal | 13 rough | 14 ior
# | 15 trans | 16 eta | 17 coatw | 18 coatr | 19-20 uv | 21 texid | 22 uvdens | 23 pad
_EPS_RAY = 1e-3
BOUNCE_BLOCK = 128  # rays per block of the bounce kernels; divides every tile width
# the path options block of the bounce kernels (path_options): firefly clamp |
# path regularization | sky | sun NEE | the sky's kernel_constants (12 floats)
PATH_OPTS = 16
# floats a row of wops_table: EA.WIDTH, alias prob and alias, padding to one
# 128-byte line
WOPS_ROW = 32


class G:
    """G-buffer rows ([G.ROWS, N] float32)."""

    POS = 0  # 3
    NS = 3  # 3 shading normal (flipped toward the viewer)
    NG = 6  # 3 geometric normal (flipped)
    BASE = 9  # 3
    METAL = 12
    ROUGH = 13
    IOR = 14
    VALID = 15
    DEPTH = 16
    WO = 17  # 3 unit direction toward the camera
    EMISS = 20  # 3 emitted radiance toward the camera
    EM_PDF_AREA = 23
    UV = 24  # 2
    TEXID = 26
    TRANS = 27
    ETA = 28
    COATW = 29
    COATR = 30
    MATID = 31
    TANG = 32  # 3
    UVDENS = 35
    INST = 36
    ROWS = 40


def tri_hits(w: torch.Tensor, o: torch.Tensor, d: torch.Tensor, t_min, t_max):
    """Woop test of rays [R, 3] against a chunk w [4, 3, C]: (t, u, v), each
    [R, C], t = INF where the ray misses or t is outside (t_min, t_max)."""

    def local(r):
        lo = (w[0, r] * o[:, 0:1] + w[1, r] * o[:, 1:2]) + w[2, r] * o[:, 2:3] + w[3, r]
        ld = (w[0, r] * d[:, 0:1] + w[1, r] * d[:, 1:2]) + w[2, r] * d[:, 2:3]
        return lo, ld

    ou, du = local(0)
    ov, dv = local(1)
    ow, dw = local(2)
    par = torch.abs(dw) < 1e-12
    t = -ow / torch.where(par, 1.0, dw)
    u = ou + t * du
    v = ov + t * dv
    valid = (~par) & (t > t_min) & (t < t_max) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return torch.where(valid, t, INF), u, v


def closest_hit_plain(woop: torch.Tensor, o: torch.Tensor, d: torch.Tensor, t_min=1e-4,
                      t_max=INF, tie: int = TRI_CHUNK):
    """Closest hit with the kernels' tie rule: within a chunk of ``tie``
    triangles the highest index among equal t wins, a later chunk only with
    a strictly smaller t. (t [N], tri [N] int64 (-1 = miss), u [N], v [N])."""
    n = o.shape[0]
    tp = woop.shape[1] // 3
    w3 = woop.reshape(4, 3, tp)
    best_t = torch.full((n,), INF, dtype=torch.float32, device=o.device)
    best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    bu = torch.zeros((n,), dtype=torch.float32, device=o.device)
    bv = torch.zeros_like(bu)
    step = max(1, RAY_CHUNK * TRI_CHUNK // tie)
    for r0 in range(0, n, step):
        rs = slice(r0, min(n, r0 + step))
        for c0 in range(0, tp, tie):
            t, u, v = tri_hits(w3[:, :, c0 : c0 + tie], o[rs], d[rs], t_min, t_max)
            tmin = t.min(1).values
            col = torch.arange(t.shape[1], device=o.device)
            idx = torch.where(t == tmin[:, None], col, -1).max(1).values
            better = tmin < best_t[rs]
            pick = idx.clamp_min(0)[:, None]
            best_t[rs] = torch.where(better, tmin, best_t[rs])
            best[rs] = torch.where(better, c0 + idx, best[rs])
            bu[rs] = torch.where(better, u.gather(1, pick)[:, 0], bu[rs])
            bv[rs] = torch.where(better, v.gather(1, pick)[:, 0], bv[rs])
    return best_t, best, bu, bv


def gbuffer_plain(scene, o: torch.Tensor, d: torch.Tensor, t_min=1e-4) -> torch.Tensor:
    """The plain PyTorch version of the G-buffer kernel: [G.ROWS, N]."""
    t_hit, tri, bu, bv = closest_hit_plain(scene.woop, o, d, t_min)
    hit = tri >= 0
    at = torch.where(hit[:, None], scene.tri_attrs[tri.clamp_min(0)], 0.0).T
    return gbuffer_rows(o, d, t_hit, hit, bu, bv, at)


def gbuffer_rows(o: torch.Tensor, d: torch.Tensor, t_hit, hit, bu, bv, at) -> torch.Tensor:
    """The G-buffer rows [G.ROWS, N] of rays o, d [N, 3] from their closest
    hits: t, hit mask, barycentrics and the winners' attribute rows at
    [A.WIDTH, N] (zeros at a miss)."""
    ov = V3(o[:, 0], o[:, 1], o[:, 2])
    dv = V3(d[:, 0], d[:, 1], d[:, 2])
    ng_raw = v3.from_rows(at, A.NG)
    front = -v3.dot(dv, ng_raw) > 0.0
    sgn = torch.where(front, 1.0, -1.0)
    ng = ng_raw * sgn
    w0 = 1.0 - bu - bv
    ns = v3.normalize(
        v3.from_rows(at, A.N0) * w0 + v3.from_rows(at, A.N1) * bu + v3.from_rows(at, A.N2) * bv
    ) * sgn
    ns = v3.where(v3.dot(ns, ng) < 0.0, -ns, ns)
    pos = ov + dv * t_hit
    le_gain = torch.where(hit & ((at[A.DOUBLE] > 0.5) | front), 1.0, 0.0)
    ior = torch.clamp_min(at[A.IOR], 1.01)
    neg1 = lambda x: torch.where(hit, x, -1.0)
    rows = {
        G.POS: pos.x, G.POS + 1: pos.y, G.POS + 2: pos.z,
        G.NS: ns.x, G.NS + 1: ns.y, G.NS + 2: ns.z,
        G.NG: ng.x, G.NG + 1: ng.y, G.NG + 2: ng.z,
        G.BASE: at[A.BASE], G.BASE + 1: at[A.BASE + 1], G.BASE + 2: at[A.BASE + 2],
        G.METAL: at[A.METAL], G.ROUGH: at[A.ROUGH], G.IOR: ior,
        G.VALID: hit.to(torch.float32),
        G.DEPTH: torch.where(hit, t_hit, 0.0),
        G.WO: -dv.x, G.WO + 1: -dv.y, G.WO + 2: -dv.z,
        G.EMISS: at[A.EMISS] * le_gain, G.EMISS + 1: at[A.EMISS + 1] * le_gain,
        G.EMISS + 2: at[A.EMISS + 2] * le_gain,
        G.EM_PDF_AREA: at[A.EM_PDF_AREA],
        G.UV: w0 * at[A.UV0] + bu * at[A.UV1] + bv * at[A.UV2],
        G.UV + 1: w0 * at[A.UV0 + 1] + bu * at[A.UV1 + 1] + bv * at[A.UV2 + 1],
        G.TEXID: neg1(at[A.TEXID]),
        G.TRANS: at[A.TRANS],
        G.ETA: torch.where(front, 1.0 / ior, ior),
        G.COATW: at[A.COATW], G.COATR: at[A.COATR],
        G.MATID: neg1(at[A.MATID]),
        G.TANG: at[A.TANG], G.TANG + 1: at[A.TANG + 1], G.TANG + 2: at[A.TANG + 2],
        G.UVDENS: at[A.UVDENS],
        G.INST: neg1(at[A.INSTID]),
    }
    return stack_rows(G.ROWS, rows)


def gbuffer(scene, o: torch.Tensor, d: torch.Tensor, t_min=1e-4) -> torch.Tensor:
    """Primary-hit G-buffer: rays o, d [N, 3] -> [G.ROWS, N]. A clustered
    scene takes the streaming closest hit (kernel B8, Moller-Trumbore t, u,
    v), a cutout scene the alpha-cutout re-trace (kernel B7 or B8 a round;
    ``accel.intersect``), then the rows, as the JAX ``gbuffer_xla`` does.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    which sweeps the ``scene.num_tris`` real triangles and needs t_min >= 0.
    """
    if scene.cluster_aabb is not None or scene.has_cutout:
        from .intersect import intersect_closest_shaded

        sh = intersect_closest_shaded(scene, o, d, t_min)
        return gbuffer_rows(o, d, sh.t, sh.valid, sh.u, sh.v, sh.attrs)
    if True:  # frozen reference: the plain version on every device
        return gbuffer_plain(scene, o, d, t_min)
    n = o.shape[0]
    tp = scene.woop.shape[1] // 3
    native.require_cuda(o, "o", torch.float32, (n, 3))
    native.require_cuda(d, "d", torch.float32, (n, 3))
    native.require_cuda(scene.woop, "woop", torch.float32, (4, 3 * tp))
    native.require_cuda(scene.tri_attrs, "tri_attrs", torch.float32, (tp, A.WIDTH))
    if tp % TRI_CHUNK:
        raise ValueError(f"triangle count {tp} is not padded to a multiple of {TRI_CHUNK}")
    check_sweep_t_min(t_min)
    out = torch.empty((G.ROWS, n), dtype=torch.float32, device=o.device)
    err = native.lib().zr_gbuffer(
        o.data_ptr(), d.data_ptr(), scene.woop_rows().data_ptr(), scene.tri_attrs.data_ptr(),
        out.data_ptr(), n, tp, scene.num_tris, t_min, native.stream_ptr(o.device),
    )
    native.check(err, "gbuffer")
    gbuffer.launches += 1
    return out


gbuffer.launches = 0


def build_light_sets(scene, seed: int, ns: int = NS, ps: int = PS) -> torch.Tensor:
    """Presampled emissive sets [ns, LSET_ROWS, ps] (salt 0xBEEF)."""
    n = ns * ps
    pix = torch.arange(n, dtype=torch.int64, device=scene.device)
    ls = sample_emissive(scene, uniform4(pix, 0, seed, salt=0xBEEF))
    rows = torch.zeros((LSET_ROWS, n), dtype=torch.float32, device=scene.device)
    rows[0:3] = ls.pos.T
    rows[3:6] = ls.ng.T
    rows[6:9] = ls.le.T
    rows[9] = ls.pdf_area
    rows[10] = ls.two_sided.to(torch.float32)
    return rows.reshape(LSET_ROWS, ns, ps).permute(1, 0, 2).contiguous()


def wops_table(scene) -> torch.Tensor:
    """The emissive table of WoPS NEE, [Ep, WOPS_ROW]: row k holds emissive
    k's ``em_attrs`` columns, then its alias prob and alias (as a float),
    then zeros. It is the transpose of the JAX package's [EA.WIDTH + 2, Ep]
    ``wops_table``, padded so that a kernel finds a light in one 128-byte
    line and its alias entry in one 8-byte word."""
    ep = scene.em_attrs.shape[0]
    table = torch.zeros((ep, WOPS_ROW), dtype=torch.float32, device=scene.em_attrs.device)
    table[:, : EA.WIDTH] = scene.em_attrs
    table[:, EA.WIDTH] = scene.em_prob
    table[:, EA.WIDTH + 1] = scene.em_alias.to(torch.float32)
    return table


def wops_pick(table, n_em: int, u_pick, u_alias):
    """WoPS NEE's pick over the ``n_em`` real emissives of ``wops_table``:
    (the first pick k0 [N], whether the alias table redirects it [N])."""
    k0 = torch.clamp_max((u_pick * n_em).to(torch.int64), n_em - 1)
    return k0, u_alias >= table[k0, EA.WIDTH]


def _wops_light(table, n_em: int, u_pick, u_alias, u_b0, u_b1):
    """WoPS NEE's light sample from ``wops_table``: an alias draw
    (``wops_pick``), then a point on that emissive's triangle
    (``square_to_triangle`` of u_b0, u_b1). Returns (position, normal, Le,
    pdf per area, two-sided)."""
    k0, redirected = wops_pick(table, n_em, u_pick, u_alias)
    k = torch.where(redirected, table[k0, EA.WIDTH + 1].to(torch.int64), k0)
    row = table[k].T
    b1, b2 = square_to_triangle(u_b0, u_b1)
    lp = v3.from_rows(row, EA.V0) + v3.from_rows(row, EA.E1) * b1 + v3.from_rows(row, EA.E2) * b2
    return (lp, v3.from_rows(row, EA.NG), v3.from_rows(row, EA.LE), row[EA.PDF_AREA],
            row[EA.TWO_SIDED] > 0.5)


# ---------------------------------------------------------------------------
# Path bounce: trace (B4), shade (B5), fused (B6)
# ---------------------------------------------------------------------------


def check_sweep_t_min(t_min) -> None:
    """The Woop test of B1 and B3-B9 (``csrc/sweep.cuh`` ``sweep_test``)
    drops a pair by the signs of its plane distances before dividing, which
    is exact for t_min >= 0."""
    if not t_min >= 0.0:
        raise ValueError(f"t_min={t_min}: the Woop test of B1 and B3-B9 needs t_min >= 0")


def _check_dense(scene, name: str,
                 instead: str = "traces with ops.pathtracer.trace_reference") -> None:
    """The dense kernels sweep the triangle table from slot 0, where a
    clustered scene has pad slots inside each cluster: such a scene
    ``instead`` (the bounce kernels: ``ops.pathtracer.trace_reference``)."""
    if scene.cluster_aabb is not None:
        raise ValueError(f"{name} sweeps the dense triangle table and takes dense scenes only; "
                         f"a clustered scene {instead}")


def _check_bounce(scene, name: str) -> None:
    """The bounce kernels take dense scenes without alpha cutout (their
    sweeps test no alpha); the others trace with
    ``ops.pathtracer.trace_reference``, as the JAX package's
    ``megakernel_eligible`` sends them."""
    _check_dense(scene, name)
    if scene.has_cutout:
        raise ValueError(f"{name} tests no alpha; a cutout scene traces with "
                         "ops.pathtracer.trace_reference")


def cone_spread(spread_angle: float) -> float:
    """The per-segment ray-cone spread as the JAX kernels carry it: whole
    micro-radians in an int32, scaled back in float32."""
    micro = np.int32(np.float32(spread_angle) * np.float32(1e6))
    return float(np.float32(micro) * np.float32(1e-6))


def material_flags(scene) -> int:
    """The material lobes the bounce kernels evaluate on ``scene``: bit 0
    the transmission lobe (``has_transmission``), bit 1 the coat
    (``has_coat``)."""
    return int(bool(scene.has_transmission)) | (int(bool(scene.has_coat)) << 1)


def hit_material(at, front, trans: bool, coat: bool):
    """The ``MatSoA`` of hits with attribute rows ``at`` [A.WIDTH, N] seen
    from the ``front`` of their geometric normals: ior clamped to 1.01,
    eta = 1 / ior entering and ior leaving; ``trans``/``coat`` as
    ``shading_soa.material``."""
    ior = torch.clamp_min(at[A.IOR], 1.01)
    return S.material(v3.from_rows(at, A.BASE), at[A.METAL], at[A.ROUGH], ior, at[A.TRANS],
                      torch.where(front, 1.0 / ior, ior), at[A.COATW], at[A.COATR], trans, coat)


def _path(st):
    """State rows -> (o, d, thr, rad, prev_pdf, alive, spec)."""
    return (v3.from_rows(st, 0), v3.from_rows(st, 3), v3.from_rows(st, 6),
            v3.from_rows(st, 9), st[12], st[13] > 0.5, st[14] > 0.5)


def path_options(cfg) -> ctypes.Array:
    """The block of PATH_OPTS floats that tells a bounce kernel the path
    options of ``cfg``: firefly clamp, path regularization, sky, sun NEE
    (the flags as 0 or 1), then the sky's ``ops.sky.kernel_constants``
    (zeros without a sky)."""
    sky = cfg.sky is not None
    vals = [cfg.firefly_clamp, float(cfg.path_regularization), float(sky),
            float(sky and cfg.sun_nee)]
    vals += SK.kernel_constants(cfg.sky) if sky else [0.0] * (PATH_OPTS - 4)
    return (ctypes.c_float * PATH_OPTS)(*vals)


def _sky_miss(d: V3, spec, miss, cfg) -> V3:
    """What a ray that misses gathers in B4 and B6 (zero where ``miss`` is
    False): the sky, and the sun disk, the disk only on specular rays
    (``spec``) when NEE samples the sun."""
    env = SK.sky_radiance(d, cfg.sky, with_disk=False)
    disk = SK.sun_disk(v3.aos3(d), cfg.sky)
    if cfg.sun_nee:
        disk = disk * torch.where(spec, 1.0, 0.0)[:, None]
    gain = torch.where(miss, 1.0, 0.0)
    return V3((env.x + disk[:, 0]) * gain, (env.y + disk[:, 1]) * gain,
              (env.z + disk[:, 2]) * gain)


def _trace_plain(scene, st, bounce: int, cfg, has_lights: bool):
    """Closest hit, the sky on a miss and MIS-weighted emission, the trace
    half of a bounce. Returns (rad, found, hit, t_hit, bu, bv, at [A.WIDTH,
    N], wo_dot_ng)."""
    o, d, thr, rad, prev_pdf, alive, spec = _path(st)
    t_hit, tri, bu, bv = closest_hit_plain(scene.woop, v3.aos3(o), v3.aos3(d), cfg.t_min)
    hit = tri >= 0
    found = hit & alive
    at = torch.where(hit[:, None], scene.tri_attrs[tri.clamp_min(0)], 0.0).T
    if cfg.sky is not None:
        rad = rad + thr * _sky_miss(d, spec, alive & ~hit, cfg)
    wo_dot_ng = -v3.dot(d, v3.from_rows(at, A.NG))
    if has_lights:
        vis_side = (at[A.DOUBLE] > 0.5) | (wo_dot_ng > 0.0)
        pdf_l_sa = at[A.EM_PDF_AREA] * t_hit * t_hit / torch.clamp_min(torch.abs(wo_dot_ng), 1e-8)
        if cfg.nee:
            mis = torch.where(spec, 1.0, S.power_heuristic(prev_pdf, pdf_l_sa))
        else:
            mis = torch.ones_like(t_hit)
        gain = torch.where(found & vis_side, mis, 0.0)
        if bounce < cfg.min_emissive_bounce:
            gain = torch.zeros_like(gain)
        rad = rad + thr * v3.from_rows(at, A.EMISS) * gain
    return rad, found, hit, t_hit, bu, bv, at, wo_dot_ng


def _surface_plain(o: V3, d: V3, t_hit, bu, bv, at, wo_dot_ng):
    """Hit point, facing-corrected normals and clamped ior: (pos, ns, ng, front, ior, w0)."""
    w0 = 1.0 - bu - bv
    ns = v3.normalize(
        v3.from_rows(at, A.N0) * w0 + v3.from_rows(at, A.N1) * bu + v3.from_rows(at, A.N2) * bv
    )
    front = wo_dot_ng > 0.0
    sgn = torch.where(front, 1.0, -1.0)
    ng = v3.from_rows(at, A.NG) * sgn
    ns = ns * sgn
    ns = v3.where(v3.dot(ns, ng) < 0.0, -ns, ns)
    return o + d * t_hit, ns, ng, front, torch.clamp_min(at[A.IOR], 1.01), w0


def _shade_plain(scene, d: V3, thr: V3, rad: V3, alive, pos: V3, ns: V3, ng: V3, mat,
                 light_sets, u, bounce: int, cfg, has_lights: bool, rt: int, pix0: int = 0):
    """NEE with its shadow segment, sun NEE with its own, BSDF sample and
    Russian roulette, the shade half of a bounce, at the regularized
    material past bounce 0 where ``cfg.path_regularization``. ``light_sets``
    is ``wops_table`` with ``cfg.nee_mode="wops"`` (and ``u`` then has its
    8 rows). Returns (o, d, thr, rad, pdf, alive, transmitted)."""
    from .intersect import occlusion_plain
    from ..ops.pathtracer import regularize

    if cfg.path_regularization and bounce >= 1:
        mat = mat._replace(roughness=regularize(mat.roughness))
    frame = S.make_frame(ns)
    wo_l = frame.to_local(-d)
    u1, u5, u6, u7, u8 = u[:5]
    if cfg.nee and has_lights:
        if cfg.nee_mode == "wops":
            lp, lng, lle, lpdf_area, l2s = _wops_light(light_sets, scene.num_emissives, u1,
                                                       *u[5:8])
        else:
            n_sets, _, ps = light_sets.shape
            pix = torch.arange(u1.shape[0], dtype=torch.int64, device=u1.device)
            set_idx = (pix0 // rt + pix // rt + bounce * 13) % n_sets
            p = torch.clamp_max((u1 * ps).to(torch.int64), ps - 1)
            srow = light_sets[set_idx, :, p].T  # [LSET_ROWS, N]
            lp, lng, lle = v3.from_rows(srow, 0), v3.from_rows(srow, 3), v3.from_rows(srow, 6)
            lpdf_area, l2s = srow[9], srow[10] > 0.5
        to_l = lp - pos
        dist2 = torch.clamp_min(v3.dot(to_l, to_l), 1e-12)
        wi_w = to_l * torch.rsqrt(dist2)
        cos_surf = v3.dot(wi_w, ns)
        cos_l_raw = -v3.dot(wi_w, lng)
        cos_l = torch.where(l2s, torch.abs(cos_l_raw), cos_l_raw)
        f, pdf_b = S.bsdf_eval(mat, wo_l, frame.to_local(wi_w))
        pdf_l_sa2 = lpdf_area * dist2 / torch.clamp_min(cos_l, 1e-8)
        candidate = alive & (cos_surf > 1e-6) & (cos_l > 1e-6) & (lpdf_area > 0.0)
        if bounce < cfg.min_nee_bounce:
            candidate = torch.zeros_like(candidate)
        # the shadow segment starts off the surface but keeps the length lp - pos
        so, seg = v3.aos3(pos + ng * _EPS_RAY), v3.aos3(to_l)
        occ = torch.zeros_like(candidate)
        occ[candidate] = occlusion_plain(scene.woop, so[candidate], seg[candidate],
                                         1e-3, 1.0 - 1e-3)
        vis = candidate & ~occ
        scale = cos_surf * S.power_heuristic(pdf_l_sa2, pdf_b) / torch.clamp_min(pdf_l_sa2, 1e-12)
        contrib = thr * f * lle * scale
        if cfg.firefly_clamp > 0.0:
            contrib = V3(*(torch.clamp_max(c, cfg.firefly_clamp) for c in contrib))
        zero = torch.zeros_like(scale)
        rad = rad + v3.where(vis, contrib, V3(zero, zero, zero))

    if cfg.sky is not None and cfg.sun_nee:  # a second segment, toward the sun
        sdir = V3(*(torch.full_like(u1, float(x)) for x in SK.sun_direction(cfg.sky)))
        e_sun = [float(x) for x in SK.sun_irradiance(cfg.sky)]
        cos_s = v3.dot(sdir, ns)
        f_s, _ = S.bsdf_eval(mat, wo_l, frame.to_local(sdir))
        cand_s = alive & (cos_s > 1e-6)
        so = v3.aos3(pos + ng * _EPS_RAY)
        occ_s = torch.zeros_like(cand_s)
        occ_s[cand_s] = occlusion_plain(scene.woop, so[cand_s], v3.aos3(sdir)[cand_s], 1e-3, 1e8)
        gain_s = torch.where(cand_s & ~occ_s, cos_s, 0.0)
        rad = rad + thr * V3(f_s.x * e_sun[0] * gain_s, f_s.y * e_sun[1] * gain_s,
                             f_s.z * e_sun[2] * gain_s)

    wi_l, wgt, pdf = S.bsdf_sample(mat, wo_l, u5, u6, u7)
    wi_w2 = frame.to_world(wi_l)
    transmitted = wi_l.z < 0.0
    side = v3.dot(wi_w2, ng)
    geo_ok = (transmitted & (side < -1e-6)) | (~transmitted & (side > 1e-6))
    alive = alive & (pdf > 0.0) & geo_ok
    thr = thr * wgt
    if bounce >= cfg.rr_start:
        q = torch.clamp(v3.max_component(thr), 0.05, 0.95)
        alive = alive & (u8 < q)
        thr = thr * (1.0 / q)
    offs = torch.where(transmitted, -_EPS_RAY, _EPS_RAY)
    return pos + ng * offs, wi_w2, thr, rad, pdf, alive, transmitted


def _state(o: V3, d: V3, thr: V3, rad: V3, pdf, alive, spec, cone) -> torch.Tensor:
    return torch.stack([*o, *d, *thr, *rad, pdf, alive.to(torch.float32), spec, cone], 0)


def bounce_trace_plain(scene, state, bounce: int, cfg, has_lights: bool, spread_angle=0.0):
    """The plain PyTorch version of the trace kernel (B4):
    (state [STATE_ROWS, N], surf [SURF_ROWS, N])."""
    o, d = v3.from_rows(state, 0), v3.from_rows(state, 3)
    rad, found, hit, t_hit, bu, bv, at, wo_dot_ng = _trace_plain(scene, state, bounce, cfg,
                                                                  has_lights)
    pos, ns, ng, front, ior, w0 = _surface_plain(o, d, t_hit, bu, bv, at, wo_dot_ng)
    spread = cone_spread(spread_angle)
    out = stack_rows(STATE_ROWS, {
        9: rad.x, 10: rad.y, 11: rad.z, 13: found.to(torch.float32),
        15: state[15] + torch.where(found, t_hit * spread, 0.0),
    }, like=state)
    surf = stack_rows(SURF_ROWS, {
        0: pos.x, 1: pos.y, 2: pos.z, 3: ns.x, 4: ns.y, 5: ns.z, 6: ng.x, 7: ng.y, 8: ng.z,
        9: at[A.BASE], 10: at[A.BASE + 1], 11: at[A.BASE + 2],
        12: at[A.METAL], 13: at[A.ROUGH], 14: ior, 15: at[A.TRANS],
        16: torch.where(front, 1.0 / ior, ior), 17: at[A.COATW], 18: at[A.COATR],
        19: w0 * at[A.UV0] + bu * at[A.UV1] + bv * at[A.UV2],
        20: w0 * at[A.UV0 + 1] + bu * at[A.UV1 + 1] + bv * at[A.UV2 + 1],
        21: torch.where(hit, at[A.TEXID], -1.0), 22: at[A.UVDENS],
    }, n=state.shape[1])
    return out, surf


def bounce_shade_plain(scene, state, surf, light_sets, bounce: int, seed: int, cfg,
                       has_lights: bool, rt: int, pix0: int = 0):
    """The plain PyTorch version of the shade kernel (B5): state [STATE_ROWS, N]."""
    _, d, thr, rad, _, alive, _ = _path(state)
    mat = S.material(v3.from_rows(surf, 9), *surf[12:19], scene.has_transmission,
                     scene.has_coat)
    u = bounce_uniforms(state.shape[1], bounce, seed, device=state.device,
                        wops=cfg.nee_mode == "wops", pix0=pix0)
    o2, d2, thr, rad, pdf, alive, transmitted = _shade_plain(
        scene, d, thr, rad, alive, v3.from_rows(surf, 0), v3.from_rows(surf, 3),
        v3.from_rows(surf, 6), mat, light_sets, u, bounce, cfg, has_lights, rt, pix0,
    )
    eta_scale = torch.where(transmitted & (surf[16] > 0.0), surf[16], 1.0)
    return _state(o2, d2, thr, rad, pdf, alive, torch.zeros_like(pdf), state[15] * eta_scale)


def bounce_plain(scene, state, light_sets, bounce: int, seed: int, cfg, last: bool,
                 has_lights: bool, rt: int, pix0: int = 0):
    """The plain PyTorch version of the fused bounce kernel (B6):
    state [STATE_ROWS, N]. ``last`` stops after the emission."""
    o, d, thr, _, prev_pdf, _, _ = _path(state)
    rad, found, _, t_hit, bu, bv, at, wo_dot_ng = _trace_plain(scene, state, bounce, cfg,
                                                                has_lights)
    if last:
        return _state(o, d, thr, rad, prev_pdf, found, state[14], state[15])
    pos, ns, ng, front, _, _ = _surface_plain(o, d, t_hit, bu, bv, at, wo_dot_ng)
    mat = hit_material(at, front, scene.has_transmission, scene.has_coat)
    u = bounce_uniforms(state.shape[1], bounce, seed, device=state.device,
                        wops=cfg.nee_mode == "wops", pix0=pix0)
    o2, d2, thr, rad, pdf, alive, _ = _shade_plain(
        scene, d, thr, rad, found, pos, ns, ng, mat, light_sets, u, bounce, cfg, has_lights, rt,
        pix0,
    )
    return _state(o2, d2, thr, rad, pdf, alive, torch.zeros_like(pdf), state[15])


def _bounce_args(scene, state, light_sets, rt: int, wops: bool = False, pix0: int = 0):
    """Validate the tensors of a bounce launch; returns (n, tp, n_sets, ps):
    with ``wops`` ``light_sets`` is ``wops_table`` and (n_sets, ps) (1, Ep)."""
    n = state.shape[1]
    tp = scene.woop.shape[1] // 3
    native.require_cuda(state, "state", torch.float32, (STATE_ROWS, n))
    native.require_cuda(scene.woop, "woop", torch.float32, (4, 3 * tp))
    native.require_cuda(scene.tri_attrs, "tri_attrs", torch.float32, (tp, A.WIDTH))
    if tp % TRI_CHUNK:
        raise ValueError(f"triangle count {tp} is not padded to a multiple of {TRI_CHUNK}")
    if light_sets is None:
        return n, tp, 1, 1
    if rt % BOUNCE_BLOCK:
        raise ValueError(f"tile width {rt} is not a multiple of {BOUNCE_BLOCK}")
    if pix0 < 0:
        raise ValueError(f"ray offset {pix0} is negative")
    if wops:
        ep = scene.em_attrs.shape[0]
        native.require_cuda(light_sets, "wops_table", torch.float32, (ep, WOPS_ROW))
        return n, tp, 1, ep
    n_sets, _, ps = light_sets.shape
    native.require_cuda(light_sets, "light_sets", torch.float32, (n_sets, LSET_ROWS, ps))
    return n, tp, n_sets, ps


def _wops_em(scene, cfg) -> int:
    """What a bounce launch's ``wops_em`` argument says: the real emissives
    WoPS NEE draws from with ``cfg.nee_mode="wops"`` and NEE on, else 0
    (the light sets)."""
    return scene.num_emissives if cfg.nee and cfg.nee_mode == "wops" else 0


def bounce_trace(scene, state, bounce: int, cfg, has_lights: bool, spread_angle=0.0):
    """Trace half of a bounce (B4): (state [STATE_ROWS, N], surf [SURF_ROWS, N]).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    which sweeps the ``scene.num_tris`` real triangles and needs t_min >= 0.
    """
    _check_bounce(scene, "bounce_trace")
    if True:  # frozen reference: the plain version on every device
        return bounce_trace_plain(scene, state, bounce, cfg, has_lights, spread_angle)
    n, tp, _, _ = _bounce_args(scene, state, None, 0)
    check_sweep_t_min(cfg.t_min)
    out = torch.empty_like(state)
    surf = torch.empty((SURF_ROWS, n), dtype=torch.float32, device=state.device)
    err = native.lib().zr_bounce_trace(
        state.data_ptr(), scene.woop_rows().data_ptr(), scene.tri_attrs.data_ptr(),
        out.data_ptr(), surf.data_ptr(), n, tp, scene.num_tris, bounce, cfg.t_min,
        cone_spread(spread_angle), cfg.min_emissive_bounce, int(cfg.nee), int(has_lights),
        path_options(cfg), native.stream_ptr(state.device),
    )
    native.check(err, "bounce_trace")
    bounce_trace.launches += 1
    return out, surf


bounce_trace.launches = 0


def bounce_shade(scene, state, surf, light_sets, bounce: int, seed: int, cfg,
                 has_lights: bool, rt: int, pix0: int = 0):
    """Shade half of a bounce (B5): state [STATE_ROWS, N]. Ray i draws its
    NEE sample from set ``(pix0 // rt + i // rt + 13 * bounce) % n_sets``,
    or with ``cfg.nee_mode="wops"`` from ``light_sets`` =
    ``wops_table(scene)``, and its uniforms from the stream of ray id
    ``pix0 + i`` (``pix0``: the global id of a row band's first ray, 0 for
    the whole image).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    whose shadow sweep tests the ``scene.num_tris`` real triangles.
    """
    _check_bounce(scene, "bounce_shade")
    if True:  # frozen reference: the plain version on every device
        return bounce_shade_plain(scene, state, surf, light_sets, bounce, seed, cfg,
                                  has_lights, rt, pix0)
    wops = _wops_em(scene, cfg)
    n, tp, n_sets, ps = _bounce_args(scene, state, light_sets, rt, wops > 0, pix0)
    native.require_cuda(surf, "surf", torch.float32, (SURF_ROWS, n))
    out = torch.empty_like(state)
    err = native.lib().zr_bounce_shade(
        state.data_ptr(), surf.data_ptr(), scene.woop_rows().data_ptr(), light_sets.data_ptr(),
        out.data_ptr(), n, tp, scene.num_tris, n_sets, ps, rt, int(pix0), bounce,
        int(seed) & 0xFFFFFFFF, cfg.min_nee_bounce, cfg.rr_start, int(cfg.nee), int(has_lights),
        wops, material_flags(scene), path_options(cfg), native.stream_ptr(state.device),
    )
    native.check(err, "bounce_shade")
    bounce_shade.launches += 1
    return out


bounce_shade.launches = 0


def bounce(scene, state, light_sets, b: int, seed: int, cfg, last: bool,
           has_lights: bool, rt: int, pix0: int = 0):
    """One whole bounce, of index ``b`` (B6): state [STATE_ROWS, N].
    ``light_sets``, ``pix0``: as for ``bounce_shade``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    _check_bounce(scene, "bounce")
    if True:  # frozen reference: the plain version on every device
        return bounce_plain(scene, state, light_sets, b, seed, cfg, last, has_lights, rt, pix0)
    wops = _wops_em(scene, cfg)
    n, tp, n_sets, ps = _bounce_args(scene, state, light_sets, rt, wops > 0, pix0)
    check_sweep_t_min(cfg.t_min)
    out = torch.empty_like(state)
    err = native.lib().zr_bounce(
        state.data_ptr(), scene.woop_rows().data_ptr(), scene.tri_attrs.data_ptr(),
        light_sets.data_ptr(), out.data_ptr(), n, tp, scene.num_tris, n_sets, ps, rt, int(pix0),
        b, int(seed) & 0xFFFFFFFF, cfg.t_min, cfg.min_emissive_bounce, cfg.min_nee_bounce,
        cfg.rr_start, int(cfg.nee), int(has_lights), int(last), wops, material_flags(scene),
        path_options(cfg), native.stream_ptr(state.device),
    )
    native.check(err, "bounce")
    bounce.launches += 1
    return out


bounce.launches = 0


def initial_state(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Path state of camera-like rays o, d [N, 3]: unit throughput, alive,
    specular (no MIS on the first emission)."""
    st = torch.zeros((STATE_ROWS, o.shape[0]), dtype=torch.float32, device=o.device)
    st[0:3] = o.T
    st[3:6] = d.T
    st[6:9] = 1.0
    st[13] = 1.0
    st[14] = 1.0
    return st


def _trace_light_sets(scene, seed: int, cfg, light_sets, device):
    """The light sets of a path trace: ``light_sets`` (the frame's) when they
    have the configured size (``cfg.light_ns``, ``cfg.light_ps``), which
    makes them the sets built from ``seed``; else sets of that size built
    from ``seed``; zeros without lights or NEE; ``wops_table`` with
    ``cfg.nee_mode="wops"``."""
    shape = (cfg.light_ns, LSET_ROWS, cfg.light_ps)
    if not (scene.num_emissives > 0 and cfg.nee):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if cfg.nee_mode == "wops":
        return wops_table(scene)
    if light_sets is not None and tuple(light_sets.shape) == shape:
        return light_sets
    return build_light_sets(scene, seed, cfg.light_ns, cfg.light_ps)


def _smb_keep(state, smb_kill) -> None:
    """Stochastic multi-bounce: the paths of ``smb_kill`` (bool [N], N up to
    the state's width) stop extending; alive (row 13) times 1 - kill."""
    keep = 1.0 - torch.nn.functional.pad(smb_kill.to(torch.float32),
                                         (0, state.shape[1] - smb_kill.shape[0]))
    state[13] = state[13] * keep


def fetch_base(textures, state, surf):
    """The texture fetch between B4 and B5: surface rows [SURF_ROWS, N] with
    the base colour (rows 9-11) times ``scene.textures.base_color_at`` at
    each vertex's uv (rows 19-20) and base-colour texture (row 21), over
    the cone width it has accumulated (state row 15) and its uv density
    (row 22); ``surf`` itself where the bundle has no base-colour map."""
    from ..scene.textures import base_color_at

    factor = base_color_at(textures, surf[19:21].T, surf[21], state[15], surf[22])
    if factor is None:
        return surf
    out = surf.clone()
    out[9:12] = surf[9:12] * factor
    return out


def trace_megakernel(scene, o, d, seed: int, cfg, rt: int = 1024, rows_out: bool = False,
                     light_sets=None, smb_kill=None, textures=None, spread_angle=0.0,
                     pix0: int = 0):
    """Path trace of rays o, d [N, 3] through the fused bounce kernel (B6):
    bounces 0..max_bounces, the last one stopping after its emission.
    Returns radiance [N, 3], or rows [3, N] with ``rows_out``.

    The rays are padded to a multiple of the tile width ``rt``, as the JAX
    function pads them: ray i draws its NEE sample from light set
    ``(pix0 // rt + i // rt + 13 * bounce) % n_sets`` and its uniforms from
    ray id ``pix0 + i`` (``pix0``: the global id of a row band's first
    ray). ``light_sets``: as in ``trace_with_first_hit``. ``smb_kill``:
    optional bool [N], paths that stop extending after bounce 0's launch.

    With ``textures`` (a bundle of ``scene.textures.load_scene_textures``)
    every bounce is split, as in the JAX function: B4, the base-colour fetch
    at each vertex with its ray cone (``fetch_base``; the cone grows by
    ``spread_angle`` per unit of distance), then B5; the last bounce is B4
    alone. The JAX split bounce hands B5 no WoPS table, so textures with
    ``cfg.nee_mode="wops"`` raise (``ROADMAP.md`` section C).
    """
    _check_bounce(scene, "trace_megakernel")
    split = bool(textures)
    if split and cfg.nee_mode == "wops" and cfg.max_bounces > 0:
        raise NotImplementedError(
            "textures with nee_mode='wops': the JAX split bounce launches B5 without the WoPS "
            "table or its uniforms, so there is no reference to hold the port to")
    n = o.shape[0]
    pad = (-n) % rt
    o_p = torch.nn.functional.pad(o, (0, 0, 0, pad))
    d_p = torch.nn.functional.pad(d, (0, 0, 0, pad))
    has_lights = scene.num_emissives > 0
    lsets = _trace_light_sets(scene, seed, cfg, light_sets, o.device)
    state = initial_state(o_p, d_p)
    for b in range(cfg.max_bounces + 1):
        last = b == cfg.max_bounces
        if not split:
            state = bounce(scene, state, lsets, b, seed, cfg, last, has_lights, rt, pix0)
        else:
            state, surf = bounce_trace(scene, state, b, cfg, has_lights, spread_angle)
            if not last:
                state = bounce_shade(scene, state, fetch_base(textures, state, surf), lsets, b,
                                     seed, cfg, has_lights, rt, pix0)
        if smb_kill is not None and b == 0:
            _smb_keep(state, smb_kill)
    rad = state[9:12, :n]
    return rad if rows_out else rad.T


def trace_with_first_hit(scene, o, d, seed: int, cfg, rt: int, light_sets=None,
                         spread_angle=0.0, smb_kill=None, textures=None, pix0: int = 0):
    """Path trace of rays o, d [N, 3] that also returns the first hit's surface:
    B4 and B5 at bounce 0, then B6 for bounces 1..max_bounces (the last one
    stops after its emission). Returns (radiance rows [3, N], surf
    [SURF_ROWS, N], alive after bounce 0 [N]).

    ``light_sets``: the frame's sets; used when they have the configured
    size (``cfg.light_ns``, ``cfg.light_ps``), which makes them the sets this
    function would build from ``seed``. Otherwise sets of that size are built.
    ``smb_kill``: optional bool [N], paths that stop extending after B5.
    ``textures``: the base colour of the first hit is fetched between B4
    and B5 (``fetch_base``; the returned surf carries it); the later
    bounces run B6 without textures, as the JAX function does.
    ``pix0``: as for ``trace_megakernel``.
    """
    _check_bounce(scene, "trace_with_first_hit")
    has_lights = scene.num_emissives > 0
    lsets = _trace_light_sets(scene, seed, cfg, light_sets, o.device)
    state, surf = bounce_trace(scene, initial_state(o, d), 0, cfg, has_lights, spread_angle)
    alive0 = state[13].clone()
    if cfg.max_bounces > 0:
        if textures:
            surf = fetch_base(textures, state, surf)
        state = bounce_shade(scene, state, surf, lsets, 0, seed, cfg, has_lights, rt, pix0)
        if smb_kill is not None:
            _smb_keep(state, smb_kill)
        for b in range(1, cfg.max_bounces + 1):
            state = bounce(scene, state, lsets, b, seed, cfg, b == cfg.max_bounces, has_lights, rt,
                           pix0)
    return state[9:12], surf, alive0
