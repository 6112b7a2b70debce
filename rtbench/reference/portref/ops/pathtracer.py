"""The path tracer, as ``ops/pathtracer.py`` of the JAX package: its settings
``PTConfig``, ``trace`` and the wavefront ``trace_reference``.

``trace`` runs the fused bounce kernel B6 once per bounce
(``accel.megakernel.trace_megakernel``) on a dense scene; a CPU tensor takes
B6's plain version. B6 sweeps the whole triangle table, so a clustered
scene takes the wavefront ``trace_reference`` instead, as in the JAX
package: per bounce one closest hit with attributes
(``accel.intersect.intersect_closest_shaded``: kernel B8) and the NEE and
sun shadow segments (``intersect_occluded``: kernel B9), with the shading
in plain PyTorch over ``ops.shading_soa``. Its NEE draws a light per ray
from the alias table (``ops.lights.sample_emissive``), not from the
presampled light sets, and its random numbers are ``uniform4(pixel,
bounce, seed, salt)`` with salt 1 (light), 2 (BSDF) and 3 (Russian
roulette).

On glass and coated materials (``SceneBuffers.has_transmission`` /
``has_coat``) the shading takes the transmission and coat lobes
(``accel.megakernel.hit_material``); a transmitted ray leaves below the
surface. A scene with alpha cutout (``has_cutout``) also takes the
wavefront, whose queries run the cutout re-trace (``accel.intersect``), as
the JAX ``megakernel_eligible`` sends it.

With ``textures`` (a ``scene.textures`` bundle) the base colour is fetched
at every path vertex with its ray cone: ``trace_megakernel`` splits each
bounce into B4, the fetch and B5; ``trace_reference`` fetches in the
wavefront, the cone widening by ``spread_angle`` a unit of distance and
scaled by eta where a ray is transmitted.

With ``PTConfig.sky`` set, rays that miss the scene gather the sky (and the
sun disk, on the specular primary rays only when ``sun_nee`` samples the
sun), and with ``sun_nee`` every vertex sends a shadow segment toward the
sun (``ops.sky``). ``path_regularization`` clamps GGX roughness at the
vertices past the first, ``firefly_clamp`` clamps each NEE sample, and the
stochastic multi-bounce mask ``smb_kill`` ends the chosen paths after their
first vertex (``ops.restir_gi.initial_samples`` draws it).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..accel.intersect import intersect_closest_shaded, intersect_occluded
from ..accel.megakernel import hit_material, trace_megakernel
from ..core import vec3 as v3
from ..core.rng import pcg4d_lanes, uniform4
from ..core.vec3 import V3
from ..scene.scene import A
from . import lights as L
from . import shading_soa as S
from . import sky as SK
from .sky import SkyParams

_EPS_RAY = 1e-3  # ray offset along the geometric normal (scene units)
# Dead rays are parked outside any scene, heading away from it: the
# streaming traversal culls them at the root box.
_PARK = 3.0e7
_PARK_DIR = (1.0, 0.0, 0.0)


@dataclass(frozen=True)
class PTConfig:
    """Field names and defaults follow the JAX package."""

    max_bounces: int = 4  # path segments after the primary hit
    rr_start: int = 3  # bounce index where Russian roulette starts
    nee: bool = True  # next-event estimation against emissive lights
    t_min: float = 1e-4
    firefly_clamp: float = 0.0  # 0 = off; else the most each NEE sample adds
    # emission at bounce < min_emissive_bounce and NEE at bounce <
    # min_nee_bounce are skipped (the DI/GI split of the frame)
    min_emissive_bounce: int = 0
    min_nee_bounce: int = 0
    sky: SkyParams | None = None  # the sun and sky environment; None: black
    sun_nee: bool = True  # with a sky: a shadow segment toward the sun per vertex
    light_ns: int = 64  # presampled light sets
    light_ps: int = 128  # samples per set
    # "wps": NEE from the presampled light sets; "wops": a per-ray draw from
    # the emissive alias table (the bounce kernels only: trace_reference,
    # the clustered scenes' path trace, ignores it, as in the JAX package)
    nee_mode: str = "wps"
    # with probability 1/2 a GI path ends after its first vertex (primary
    # roughness >= 0.1; ops.restir_gi.initial_samples draws the mask)
    stochastic_multi_bounce: bool = False
    # GGX alpha < 0.25 -> clamp(2 alpha, 0.1, 0.25) at the vertices past the first
    path_regularization: bool = False


def megakernel_eligible(scene) -> bool:
    """Whether the bounce kernels take the scene: dense and without alpha
    cutout (the JAX function also asks for a TPU)."""
    return scene.cluster_aabb is None and not scene.has_cutout


def trace(scene, o, d, seed: int, cfg: PTConfig = PTConfig(), rt: int = 1024,
          rows_out: bool = False, light_sets=None, smb_kill=None, textures=None,
          spread_angle=0.0, pix0: int = 0):
    """Path-traced radiance of rays o, d [N, 3]: [N, 3] linear HDR, or rows
    [3, N] with ``rows_out``. ``seed`` is the u32 frame seed; ``rt`` the tile
    width that picks each ray's light set; ``pix0`` the global id of the
    first ray (a row band's offset, 0 for the whole image), which moves
    every ray's random stream and tile. ``light_sets``: the frame's sets,
    used where they are the ones ``seed`` gives (``trace_megakernel``). A
    clustered or cutout scene takes ``trace_reference``, which reads neither.
    ``smb_kill``: optional bool [N], paths that end after their first vertex.
    ``textures``, ``spread_angle``: the base-colour fetch at every vertex."""
    if not megakernel_eligible(scene):
        out = trace_reference(scene, o, d, seed, cfg, smb_kill=smb_kill, textures=textures,
                              spread_angle=spread_angle, pix0=pix0)
        return out.T if rows_out else out
    return trace_megakernel(scene, o, d, seed, cfg, rt=rt, rows_out=rows_out,
                            light_sets=light_sets, smb_kill=smb_kill, textures=textures,
                            spread_angle=spread_angle, pix0=pix0)


def park(mask, o: torch.Tensor, d: torch.Tensor):
    """Rays o, d [N, 3] where ``mask`` is False moved outside the scene:
    every use of their results is gated by the same mask."""
    pd = torch.tensor(_PARK_DIR, dtype=d.dtype, device=d.device)
    return torch.where(mask[:, None], o, _PARK), torch.where(mask[:, None], d, pd)


def regularize(rough: torch.Tensor) -> torch.Tensor:
    """Path regularization of a roughness: GGX alpha below 0.25 becomes
    clamp(2 alpha, 0.1, 0.25)."""
    alpha = rough * rough
    return torch.sqrt(torch.where(alpha < 0.25, torch.clamp(2.0 * alpha, 0.1, 0.25), alpha))


def _div(a: V3, s) -> V3:
    return V3(a.x / s, a.y / s, a.z / s)


def trace_reference(scene, o, d, seed: int, cfg: PTConfig = PTConfig(),
                    return_first_hit: bool = False, smb_kill=None, textures=None,
                    spread_angle=0.0, pix0: int = 0):
    """Wavefront path trace of rays o, d [N, 3]: radiance [N, 3], and with
    ``return_first_hit`` also the bounce-0 ``ShadedHit`` (the GI pass reads
    its reconnection vertex from it). Bounces 0..max_bounces, the last one
    stopping after its emission. Dead rays are parked (``park``).
    ``smb_kill``: optional bool [N], paths that stop extending after bounce
    0's BSDF sample (before Russian roulette). Its NEE draws from the
    emissive alias table whatever ``cfg.nee_mode`` says, as the JAX
    function does. ``textures``: the base colour at each vertex times
    ``base_color_at`` over the ray cone's width so far (the hit distances
    of the live segments times ``spread_angle``, scaled by eta at each
    transmission); the JAX function does not quantize the spread, as the
    bounce kernels do (``megakernel.cone_spread``). Ray i's random streams
    are those of pixel id ``pix0 + i``."""
    from ..scene.textures import base_color_at_hits

    n = o.shape[0]
    dev = o.device
    pixel = torch.arange(n, dtype=torch.int64, device=dev) + pix0
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    radiance = V3(zero, zero, zero)
    throughput = v3.splat(torch.ones_like(zero))
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = zero
    spec_bounce = torch.ones_like(alive)  # primary rays count as specular
    has_lights = scene.num_emissives > 0
    cone_w = zero  # the ray cone's accumulated width (texturing)

    sh0 = None
    for bounce in range(cfg.max_bounces + 1):
        sh = intersect_closest_shaded(scene, o, d, t_min=cfg.t_min)
        if bounce == 0:
            sh0 = sh
        found = sh.valid & alive
        ov, dv = V3(o[:, 0], o[:, 1], o[:, 2]), V3(d[:, 0], d[:, 1], d[:, 2])
        at = sh.attrs
        # the hit's surface
        w0 = 1.0 - sh.u - sh.v
        ng_raw = v3.from_rows(at, A.NG)
        ns = v3.from_rows(at, A.N0) * w0 + v3.from_rows(at, A.N1) * sh.u \
            + v3.from_rows(at, A.N2) * sh.v
        ns = _div(ns, torch.clamp_min(torch.sqrt(v3.dot(ns, ns)), 1e-20))
        front = v3.dot(dv, ng_raw) < 0.0
        sign = torch.where(front, 1.0, -1.0)
        ng = ng_raw * sign
        ns = ns * sign
        ns = v3.where(v3.dot(ns, ng) < 0.0, -ns, ns)
        pos = ov + dv * sh.t
        # the JAX wavefront keeps the transmission lobe on every scene; with
        # transmission 0 everywhere it gives the opaque lobes' results
        mat = hit_material(at, front, scene.has_transmission, scene.has_coat)
        if cfg.path_regularization and bounce > 0:
            mat = mat._replace(roughness=regularize(mat.roughness))
        if textures:
            cone_w = cone_w + torch.where(alive & sh.valid, sh.t, 0.0) * spread_angle
            factor = base_color_at_hits(textures, sh, cone_w)
            if factor is not None:
                mat = mat._replace(base=mat.base * v3.from_rows(factor, 0))

        # the sky, and the sun disk (only on specular rays where NEE samples
        # the sun), on rays that miss
        if cfg.sky is not None:
            env = SK.sky_radiance(dv, cfg.sky, with_disk=False)
            disk = SK.sun_disk(d, cfg.sky)
            if cfg.sun_nee:
                disk = disk * spec_bounce[:, None].to(disk.dtype)
            env = V3(env.x + disk[:, 0], env.y + disk[:, 1], env.z + disk[:, 2])
            radiance = radiance + v3.where(alive & ~sh.valid, throughput * env, v3.splat(zero))

        # emitted radiance at the hit, MIS-weighted against the previous NEE
        if has_lights and bounce >= cfg.min_emissive_bounce:
            wo_dot_ng = -v3.dot(dv, ng_raw)
            visible = (at[A.DOUBLE] > 0.5) | (wo_dot_ng > 0.0)
            le = v3.where(visible, v3.from_rows(at, A.EMISS), v3.splat(zero))
            if cfg.nee and bounce > 0:
                pdf_l_sa = L.pdf_area_to_solid_angle(at[A.EM_PDF_AREA], sh.t * sh.t,
                                                     torch.abs(wo_dot_ng))
                mis = torch.where(spec_bounce, 1.0, S.power_heuristic(prev_pdf, pdf_l_sa))
            else:
                mis = torch.ones_like(zero)
            radiance = radiance + v3.where(found, throughput * le * mis, v3.splat(zero))

        alive = found
        if bounce == cfg.max_bounces:
            break

        frame = S.make_frame(ns)
        wo_l = frame.to_local(-dv)

        # NEE: one shadow segment toward a point on an emissive triangle
        if cfg.nee and has_lights and bounce >= cfg.min_nee_bounce:
            ls = L.sample_emissive(scene, uniform4(pixel, bounce, seed, salt=1))
            to_l = V3(ls.pos[:, 0], ls.pos[:, 1], ls.pos[:, 2]) - pos
            dist2 = torch.clamp_min(v3.dot(to_l, to_l), 1e-12)
            wi_w = to_l * torch.rsqrt(dist2)
            cos_surf = v3.dot(wi_w, ns)
            cos_light_raw = -v3.dot(wi_w, V3(ls.ng[:, 0], ls.ng[:, 1], ls.ng[:, 2]))
            cos_light = torch.where(ls.two_sided, torch.abs(cos_light_raw), cos_light_raw)
            f, pdf_b = S.bsdf_eval(mat, wo_l, frame.to_local(wi_w))
            pdf_l_sa = L.pdf_area_to_solid_angle(ls.pdf_area, dist2, cos_light)
            candidate = alive & (cos_surf > 1e-6) & (cos_light > 1e-6)
            # the unnormalised segment as direction: the light sits at t = 1
            so, sd = park(candidate, v3.aos3(pos + ng * _EPS_RAY), v3.aos3(to_l))
            occluded = intersect_occluded(scene, so, sd, t_min=1e-3, t_max=1.0 - 1e-3)
            vis = candidate & ~occluded
            mis = S.power_heuristic(pdf_l_sa, pdf_b)
            le_l = V3(ls.le[:, 0], ls.le[:, 1], ls.le[:, 2])
            contrib = throughput * f * le_l * (cos_surf * mis / torch.clamp_min(pdf_l_sa, 1e-12))
            if cfg.firefly_clamp > 0.0:
                contrib = V3(*(torch.clamp_max(c, cfg.firefly_clamp) for c in contrib))
            radiance = radiance + v3.where(vis, contrib, v3.splat(zero))

        # sun NEE: a shadow segment toward the sun (a delta light), in (1e-3, 1e8)
        if cfg.sky is not None and cfg.sun_nee:
            sdir = V3(*(torch.full_like(zero, float(x)) for x in SK.sun_direction(cfg.sky)))
            cos_s = v3.dot(sdir, ns)
            f_s, _ = S.bsdf_eval(mat, wo_l, frame.to_local(sdir))
            sun_cand = alive & (cos_s > 1e-6)
            so, sd = park(sun_cand, v3.aos3(pos + ng * _EPS_RAY), v3.aos3(sdir))
            occ_s = intersect_occluded(scene, so, sd, t_min=1e-3, t_max=1e8)
            e_sun = V3(*map(float, SK.sun_irradiance(cfg.sky)))
            radiance = radiance + v3.where(sun_cand & ~occ_s, throughput * f_s * e_sun * cos_s,
                                           v3.splat(zero))

        # BSDF sample of the next direction
        u_b = uniform4(pixel, bounce, seed, salt=2)
        wi_l, weight, pdf = S.bsdf_sample(mat, wo_l, u_b[0], u_b[1], u_b[2])
        wi_w = frame.to_world(wi_l)
        # reflected rays leave above the geometric surface, transmitted below
        transmitted = wi_l.z < 0.0
        if textures:  # refraction scales the cone's width by eta
            ior = torch.clamp_min(at[A.IOR], 1.01)
            cone_w = cone_w * torch.where(transmitted, torch.where(front, 1.0 / ior, ior), 1.0)
        side = v3.dot(wi_w, ng)
        geo_ok = torch.where(transmitted, side < -1e-6, side > 1e-6)
        alive = alive & (pdf > 0.0) & geo_ok
        throughput = throughput * weight
        prev_pdf = pdf
        spec_bounce = torch.zeros_like(alive)
        if smb_kill is not None and bounce == 0:
            alive = alive & ~smb_kill  # full shading at the first vertex, no extension

        if bounce >= cfg.rr_start:
            q = torch.clamp(v3.max_component(throughput), 0.05, 0.95)
            alive = alive & (uniform4(pixel, bounce, seed, salt=3)[0] < q)
            throughput = _div(throughput, q)

        offset = torch.where(transmitted, -1.0, 1.0)
        o, d = park(alive, v3.aos3(pos + ng * _EPS_RAY * offset), v3.aos3(wi_w))

    rad = v3.aos3(radiance)
    return (rad, sh0) if return_first_hit else rad


SPP_SALT = 0x5350  # the third pcg4d counter of render_spp's sample seeds


def _sample_seed(seed: int, i: int) -> int:
    """The u32 frame seed of sample ``i`` of ``render_spp``: the first lane
    of pcg4d(seed, i, SPP_SALT, 0). (The JAX function folds ``i`` into its
    PRNG key, a stream the port's u32 seeds cannot give.)"""
    lane = lambda v: torch.tensor([int(v) & 0xFFFFFFFF], dtype=torch.int64)
    return int(pcg4d_lanes(lane(seed), lane(i), lane(SPP_SALT), lane(0))[0])


def render_spp(scene, camera, width: int, height: int, seed: int, cfg: PTConfig = PTConfig(),
               spp: int = 1) -> torch.Tensor:
    """``spp`` path-traced samples a pixel of the camera's rays, averaged:
    [H*W, 3] HDR on ``scene.device``. One sample takes the frame seed
    ``seed``, as the JAX function takes its key; sample i of several
    takes ``_sample_seed(seed, i)``."""
    o, d = camera.generate_rays(width, height, device=scene.device)
    if spp == 1:
        return trace(scene, o, d, seed, cfg)
    acc = torch.zeros((width * height, 3), dtype=torch.float32, device=scene.device)
    for i in range(spp):
        acc = acc + trace(scene, o, d, _sample_seed(seed, i), cfg)
    return acc / spp
