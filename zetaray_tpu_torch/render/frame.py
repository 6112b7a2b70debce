"""The frames of the JAX package's ``render/frame.py``: ``render_frame_restir``
and the plain path-traced ``render_frame``.

``render_frame_restir`` covers ``mode="restir_di"`` (the JAX app's default
frame: ReSTIR DI with the indirect light path-traced), ``mode="restir_gi"``
(the flagship ``RenderConfig(mode="restir_gi", pt=PTConfig(max_bounces=3),
denoise=True, taa=True)``), ``mode="restir_pt"`` and ``mode="pt"`` (which
takes the branches of ``"restir_di"``, as in the JAX frame), with the
indirect pass on or off. It runs camera rays -> G-buffer -> presampled
light sets -> DI RIS -> DI temporal -> DI visibility -> DI spatial -> DI
shade -> the indirect pass (a path trace of the camera rays past their
first hit, or ReSTIR GI or ReSTIR PT: initial samples, temporal reuse with
boiling suppression, spatial reuse, shade) -> the firefly filter -> a-trous -> TAA
or the temporal upscaler -> exposure (histogram or weighted average), a
tonemapper of ``ops.post.TONEMAPPERS_P``, RCAS after an upscale, and sRGB,
in the JAX frame's order. In the GI and PT modes one
reprojection and one gather serve both temporal passes, and the pre-spatial
DI and indirect reservoirs are fed forward. ``render_frame`` path-traces
the camera rays with ``cfg.pt`` whatever ``cfg.mode`` says, as the JAX
function does. ``shard`` raises ``NotImplementedError``; an unknown mode
or tonemapper raises ``ValueError``.

Animated geometry: ``motion`` [I+1, 3, 4] holds each instance's curr ->
prev world transform (row I the identity, which primary misses take),
``animation.transform_deltas(W_curr, W_prev)[0]``. ``_prev_positions``
gives each pixel's hit point in the previous frame, and every temporal
pass (the joint gather, DI, GI, PT and SkyDI temporal reuse) and TAA or
the upscaler reproject that point instead of the current one. The scene
itself moves through ``scene.refit.refit_scene`` before the frame.

With ``render_scale`` != 1 everything up to the post chain runs at the
render resolution (``render_size``) and ``ops.upscale.taau_resolve``
reconstructs the display image in place of TAA; reservoirs and G-buffer
stay at render resolution, the history and the luminance locks
(``FrameState.upscale_lock``) at display resolution.

A thin-lens camera (``Camera.lens_radius`` > 0) takes its lens uniforms from
``_lens_u``: ``uniform4(pixel, 0, seed, 0x0D0F)``. The JAX frame draws them
with ``jax.random`` from its PRNG key, a stream the port's u32 frame seed
cannot give; the feature is the same, the random stream is not.

With ``pt.sky`` set (the JAX app's ``--sun``) the path traces gather the
sky and the sun (``ops.sky``), and the GI and PT modes add what the path
trace gives the other modes: the sky behind primary-miss pixels and the
sun's light at the primary hits, either from SkyDI (``skydi``: reservoirs
over sky directions, ``ops.skydi``) or from ``_sky_direct`` (the JAX
frame's SkyDI-lite). ``volumetrics`` composites froxel inscattering
(``ops.volumetrics``) before the post chain, in both frames. The light
voxel grid (``ops.prelighting``) is built once a frame where
``restir.lvg_samples`` > 0 (extra DI candidates) or ``restir_gi.lvg`` asks
for it (the GI path's NEE at x2).

On a clustered scene (``scene.cluster_aabb`` set) every ray query goes
through the streaming kernels B8/B9 and the path traces through the
wavefront ``ops.pathtracer.trace_reference``. On a scene with alpha cutout
(``scene.has_cutout``) every ray query is the cutout re-trace
(``accel.intersect``: B7 or B8 a round) and the path traces take the
wavefront too, in both frames.

``textures`` (the bundle of ``scene.textures.load_scene_textures``, on the
scene's device) texture the G-buffer right after it is traced
(``apply_textures_to_gbuffer``: base colour, metallic-roughness, emissive
and the normal map, ray-cone mips at the render height's pixel spread),
and the indirect pass fetches the base colour at its path vertices: the
GI trace at x2, the PT initial samples at x_rc, x3 and along the suffix,
the ``restir_di`` path trace at every vertex (B4, the fetch, B5 a bounce).

Glass and coated materials: every pass takes ``trans =
scene.has_transmission`` and ``coat = scene.has_coat``, as the JAX frame
does, and shades with the transmission and coat lobes where they are set
(SkyDI-lite, ``_sky_direct``, with the coat alone, as in JAX). The reuse
options ``full_target`` and ``packed_reuse=False`` of the three ReSTIR
configs act in their passes; the joint temporal gather runs only where
every temporal pass it serves gathers packed.

The JAX frame's banded gathers (``band_rows``/``band_halo``) are a TPU
workaround and have no counterpart here: the two fields are accepted and
have no effect, and reuse gathers read the whole previous frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from ..accel.intersect import intersect_occluded
from ..accel.megakernel import G, build_light_sets, gbuffer
from ..core import vec3 as v3
from ..core.rng import uniform4
from ..core.vec3 import V3
from ..ops import denoise as DN
from ..ops import post
from ..ops import prelighting as PL
from ..ops import restir_di as RD
from ..ops import restir_gi as RG
from ..ops import restir_pt as RP
from ..ops import shading_soa as S
from ..ops import sky as SK
from ..ops import skydi as SD
from ..ops import taa as TA
from ..ops import upscale as UP
from ..ops import volumetrics as VL
from ..ops.gbuffer_pack import TG, pack_temporal
from ..ops.pathtracer import PTConfig, trace
from ..ops.reservoir_pack import pack_di, pack_pt, unpack_di, unpack_pt
from ..scene.camera import Camera


MODES = ("pt", "restir_di", "restir_gi", "restir_pt")


@dataclass(frozen=True)
class RenderConfig:
    """Per-frame settings; field names and defaults follow the JAX package."""

    width: int = 512
    height: int = 512
    mode: str = "pt"
    pt: PTConfig = field(default_factory=PTConfig)
    restir: RD.ReSTIRConfig = field(default_factory=RD.ReSTIRConfig)
    restir_gi: RG.ReSTIRGIConfig | None = None  # None: the default, built in __post_init__
    restir_pt: RP.ReSTIRPTConfig | None = None  # None: the default, built in __post_init__
    indirect: bool = True
    lvg_cfg: PL.LVGConfig | None = None  # None: the default, built in __post_init__
    skydi: bool = False  # SkyDI in the GI and PT modes (with pt.sky)
    skydi_cfg: SD.SkyDIConfig | None = None  # None: the default, built in __post_init__
    volumetrics: VL.VolumetricsConfig | None = None  # froxel inscattering (with pt.sky)
    render_scale: float = 1.0
    upscale_cfg: UP.UpscaleConfig | None = None  # None: the default, built in __post_init__
    band_rows: int = -1  # accepted, no effect: the port has no banded gathers
    band_halo: int = 64  # accepted, no effect
    tonemapper: str = "agx"
    auto_exposure: bool = True
    exposure_mode: str = "histogram"
    manual_exposure: float = 1.0
    firefly_factor: float = 0.0
    denoise: bool = False
    taa: bool = True

    def __post_init__(self):
        if self.restir_gi is None:
            object.__setattr__(self, "restir_gi", RG.ReSTIRGIConfig())
        if self.restir_pt is None:
            object.__setattr__(self, "restir_pt", RP.ReSTIRPTConfig())
        if self.lvg_cfg is None:
            object.__setattr__(self, "lvg_cfg", PL.LVGConfig())
        if self.skydi_cfg is None:
            object.__setattr__(self, "skydi_cfg", SD.SkyDIConfig())
        if self.upscale_cfg is None:
            object.__setattr__(self, "upscale_cfg", UP.UpscaleConfig())

    def check_ported(self) -> None:
        """Raise ``ValueError`` for a mode that is none of ``MODES`` or a
        tonemapper that ``ops.post.TONEMAPPERS_P`` does not name. Both frame
        functions render every mode."""
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; one of {MODES}")
        if self.tonemapper not in post.TONEMAPPERS_P:
            raise ValueError(f"unknown tonemapper {self.tonemapper!r}; "
                             f"one of {sorted(post.TONEMAPPERS_P)}")

    def render_size(self) -> tuple[int, int]:
        """(width, height) the frame renders at before the upscaler."""
        if self.render_scale == 1.0:
            return self.width, self.height
        return (max(8, int(round(self.width * self.render_scale))),
                max(8, int(round(self.height * self.render_scale))))


@dataclass(frozen=True)
class FrameState:
    """Temporal state carried between frames."""

    reservoirs: torch.Tensor  # [16, N] DI reservoirs (pre-spatial)
    # pre-spatial indirect reservoirs: [16, N] ReSTIR GI or [RP.PR.ROWS, N]
    # ReSTIR PT; [16, N] zeros without the indirect pass
    gi_reservoirs: torch.Tensor
    gbuf: torch.Tensor  # [TG.ROWS, N] packed temporal G-buffer
    camera_prev: Camera
    history: torch.Tensor  # [3, H, W] TAA history (HDR), at display resolution
    sky_reservoirs: torch.Tensor | None = None  # [16, N] SkyDI reservoirs (pre-spatial)
    upscale_lock: torch.Tensor | None = None  # [H, W] the upscaler's luminance locks


def pick_rt(n: int) -> int:
    """The JAX frame's ray-tile width for n pixels; it fixes which light set
    each pixel's RIS draws from."""
    for rt in (1024, 512, 256, 128):
        if n % rt == 0:
            return rt
    return 1024


def _postprocess(hdr, cfg: RenderConfig, ldr_transform=None):
    """Planar [3, H, W] linear radiance -> [3, H, W] uint8 sRGB.
    ``ldr_transform``: applied after the tonemap (RCAS after an upscale)."""
    if not cfg.auto_exposure:
        exposure = cfg.manual_exposure
    elif cfg.exposure_mode == "weighted_avg":
        exposure, _ = post.weighted_avg_exposure_p(hdr)
    else:
        exposure = post.histogram_exposure_p(hdr)
    ldr = post.TONEMAPPERS_P[cfg.tonemapper](hdr * exposure)
    if ldr_transform is not None:
        ldr = ldr_transform(ldr)
    return post.to_u8(post.srgb_encode(ldr))


def _prev_positions(gb, motion) -> torch.Tensor:
    """Each pixel's hit point in the previous frame, [N, 3]: its instance's
    row of ``motion`` [I+1, 3, 4] (curr -> prev; a miss, G.INST -1, takes
    row I, the identity) applied to G.POS."""
    motion = torch.as_tensor(motion, dtype=torch.float32, device=gb.device)
    inst = gb[G.INST]
    m = motion[torch.where(inst < 0.0, motion.shape[0] - 1, inst).long()]
    return torch.einsum("nij,nj->ni", m[:, :, :3], gb[G.POS : G.POS + 3].T) + m[:, :, 3]


def _lens_u(camera: Camera, seed: int, n: int, device):
    """Per-pixel lens-disk uniforms [n, 2] of a thin-lens camera, or None
    for a pinhole: ``uniform4(pixel, 0, seed, 0x0D0F)``, the first two.
    (The JAX frame draws them with ``jax.random`` from its key.)"""
    if camera.lens_radius <= 0.0:
        return None
    u = uniform4(torch.arange(n, device=device), 0, seed, salt=0x0D0F)
    return torch.stack([u[0], u[1]], -1)


def _sky_background(gb, sky) -> torch.Tensor:
    """The sky and the sun disk behind primary-miss pixels, zero elsewhere: [3, N]."""
    d = -v3.from_rows(gb, G.WO)
    env = SK.sky_radiance(d, sky, with_disk=False)
    env_rgb = torch.stack([env.x, env.y, env.z], 0) + SK.sun_disk(v3.aos3(d), sky).T
    return torch.where((gb[G.VALID] > 0.5)[None, :], 0.0, env_rgb)


def _sky_direct(scene, gb, sky) -> torch.Tensor:
    """The sky behind primary-miss pixels and the sun's light at the primary
    hits, through a shadow segment toward the sun in (1e-3, 1e8) (B3, or B9
    on a clustered scene): [3, N]. The GI and PT modes add it; the other
    modes' path trace gives both. The BSDF takes the coat where the scene
    has one and, as in the JAX frame, no transmission lobe."""
    pos, ns, ng, wo, mat, valid = RD.surface_from_gbuf(gb, coat=scene.has_coat)
    frame = S.make_frame(ns)
    sdir = V3(*(torch.full_like(gb[G.VALID], float(x)) for x in SK.sun_direction(sky)))
    cos_s = v3.dot(sdir, ns)
    f_s, _ = S.bsdf_eval(mat, frame.to_local(wo), frame.to_local(sdir))
    occ = intersect_occluded(scene, v3.aos3(pos + ng * 1e-3), v3.aos3(sdir), t_min=1e-3,
                             t_max=1e8)
    e_sun = SK.sun_irradiance(sky)
    gain = torch.where(valid & (cos_s > 1e-6) & ~occ, cos_s, 0.0)
    sun = torch.stack([f_s.x * float(e_sun[0]) * gain, f_s.y * float(e_sun[1]) * gain,
                       f_s.z * float(e_sun[2]) * gain], 0)
    return _sky_background(gb, sky) + sun


def _inscatter(scene, camera, gb, hdr, cfg: RenderConfig):
    """hdr [3, h, w] through the froxel grid of this frame's camera."""
    froxels = VL.build_froxels(scene, camera, cfg.pt.sky, cfg.volumetrics)
    h, w = hdr.shape[1:]
    return VL.apply_inscattering(hdr, gb, camera, froxels, cfg.volumetrics, w, h)


def _skydi(scene, gb, state, w, h, seed, cfg: RenderConfig, pos_prev=None):
    """SkyDI's direct light ([3, N]) and the pre-spatial reservoirs the next
    frame reuses."""
    sky, sd_cfg = cfg.pt.sky, cfg.skydi_cfg
    mat = dict(trans=scene.has_transmission, coat=scene.has_coat)
    sky_res = SD.initial_candidates(gb, sky, seed, sd_cfg, **mat)
    if sd_cfg.temporal and state is not None and state.sky_reservoirs is not None:
        sky_res = SD.temporal_reuse(sky_res, state.sky_reservoirs, state.gbuf, gb,
                                    state.camera_prev, w, h, seed, sd_cfg, sky,
                                    pos_prev=pos_prev, **mat)
    sky_sp = SD.spatial_reuse(sky_res, gb, w, h, seed, sd_cfg, **mat)
    return SD.shade(scene, sky_sp, gb, **mat), sky_res


def render_frame(scene, camera: Camera, seed: int, cfg: RenderConfig):
    """One plain path-traced frame on ``scene.device``: {"hdr": [H, W, 3]
    float32, "ldr": [H, W, 3] uint8}. ``seed`` is the u32 frame seed. The
    camera rays are path-traced by B6 with ``cfg.pt`` whatever ``cfg.mode``
    says. Like the JAX function it renders at the display size (no
    upscaler)."""
    cfg.check_ported()
    w, h = cfg.width, cfg.height
    o, d = camera.generate_rays(w, h, _lens_u(camera, seed, w * h, scene.device),
                                device=scene.device)
    hdr = trace(scene, o, d, seed, cfg.pt, rows_out=True).reshape(3, h, w)
    if cfg.volumetrics is not None and cfg.pt.sky is not None:
        hdr = _inscatter(scene, camera, gbuffer(scene, o, d), hdr, cfg)
    ldr = _postprocess(hdr, cfg)
    return {"hdr": hdr.permute(1, 2, 0), "ldr": ldr.permute(1, 2, 0)}


def render_frame_restir(scene, camera: Camera, seed: int, cfg: RenderConfig,
                        state: FrameState | None, textures=None, motion=None, shard=None):
    """One frame on ``scene.device``: returns ({"hdr": [H, W, 3] float32,
    "ldr": [H, W, 3] uint8}, FrameState) at the display size.
    ``seed`` is the u32 frame seed; ``textures``: a texture bundle on the
    scene's device; ``motion``: [I+1, 3, 4] curr -> prev instance transforms
    (module docstring)."""
    from ..scene.textures import apply_textures_to_gbuffer

    cfg.check_ported()
    if shard is not None:
        raise NotImplementedError("shard is not ported yet")
    w, h = cfg.render_size()
    dev = scene.device
    o, d = camera.generate_rays(w, h, _lens_u(camera, seed, w * h, dev), device=dev)
    rt = pick_rt(w * h)

    gb = gbuffer(scene, o, d)
    spread = camera.pixel_spread_angle(h)
    tex = dict(textures=textures, spread_angle=spread)
    if textures:
        gb = apply_textures_to_gbuffer(gb, textures, spread_angle=spread)
    pos_prev = _prev_positions(gb, motion) if motion is not None else None
    lsets = build_light_sets(scene, seed)
    mat = dict(trans=scene.has_transmission, coat=scene.has_coat)
    pt_mode = cfg.mode == "restir_pt"
    ind_cfg = cfg.restir_pt if pt_mode else cfg.restir_gi
    pack_ind, unpack_ind = (pack_pt, unpack_pt) if pt_mode else (pack_di, unpack_di)

    # Joint temporal gather (GI and PT modes, both passes gathering packed):
    # the DI and indirect reservoirs and the packed temporal G-buffer
    # reproject alike, so one reprojection and one gather serve both
    # temporal passes.
    pf_di = pf_ind = None
    if (state is not None and cfg.indirect and cfg.restir.temporal and ind_cfg.temporal
            and cfg.restir.packed_reuse and ind_cfg.packed_reuse
            and cfg.mode in ("restir_gi", "restir_pt")):
        idx, inside, depth_est = RD.reproject_prev(gb, state.camera_prev, w, h, pos_prev)
        p_di, p_ind, p_g = RD.take_multi(
            [pack_di(state.reservoirs), pack_ind(state.gi_reservoirs), state.gbuf], idx
        )
        pf_di = (unpack_di(p_di), p_g, inside, depth_est)
        pf_ind = (unpack_ind(p_ind), p_g, inside, depth_est)

    res = RD.initial_candidates(gb, lsets, seed, rt=rt, **mat)
    gi_lvg = cfg.mode == "restir_gi" and cfg.restir_gi.lvg and cfg.indirect
    lvg = None
    if cfg.restir.lvg_samples > 0 or gi_lvg:
        lvg = PL.build_light_voxel_grid(scene, camera, seed, cfg.lvg_cfg)
    if cfg.restir.lvg_samples > 0:
        res = RD.lvg_merge(res, gb, camera, lvg, seed, cfg.restir, cfg.lvg_cfg, **mat)
    if cfg.restir.temporal and state is not None:
        res = RD.temporal_reuse(
            res, state.reservoirs, state.gbuf, gb, state.camera_prev, w, h, seed, cfg.restir,
            pos_prev=pos_prev, prefetch=pf_di, **mat,
        )
    res = RD.visibility_reuse(scene, res, gb)
    res_sp = RD.spatial_reuse(res, gb, w, h, seed, cfg.restir, **mat)
    direct = RD.shade(scene, res_sp, gb, **mat)
    # SkyDI: the GI and PT modes take the sky's direct light from reservoirs
    use_skydi = cfg.skydi and cfg.pt.sky is not None and cfg.mode in ("restir_gi", "restir_pt")
    sky_res = None
    if use_skydi:
        sky_direct, sky_res = _skydi(scene, gb, state, w, h, seed, cfg, pos_prev)
        direct = direct + sky_direct + _sky_background(gb, cfg.pt.sky)

    ind_res = torch.zeros_like(res)
    pt_cfg = replace(cfg.pt, min_emissive_bounce=2, min_nee_bounce=1)
    temporal = ind_cfg.temporal and state is not None
    indirect = None
    if cfg.indirect and pt_mode:
        ind_res = RP.initial_samples(scene, gb, pt_cfg, seed, cfg.restir_pt, rt,
                                     light_sets=lsets, **mat, **tex)
        if temporal:
            ind_res = RP.temporal_reuse(
                ind_res, state.gi_reservoirs, state.gbuf, gb, state.camera_prev, w, h, seed,
                cfg.restir_pt, scene=scene, pos_prev=pos_prev, prefetch=pf_ind, **mat,
            )
        pt_sp = RP.spatial_reuse(ind_res, gb, w, h, seed, cfg.restir_pt, scene=scene, **mat)
        indirect = RP.shade(scene, pt_sp, gb, **mat)
    elif cfg.indirect and cfg.mode == "restir_gi":
        ind_res = RG.initial_samples(scene, gb, pt_cfg, seed, rt, light_sets=lsets,
                                     lvg=lvg if gi_lvg else None, lvg_cam=camera,
                                     lvg_cfg=cfg.lvg_cfg, full_target=cfg.restir_gi.full_target,
                                     **mat, **tex)
        if temporal:
            ind_res = RG.temporal_reuse(
                ind_res, state.gi_reservoirs, state.gbuf, gb, state.camera_prev, w, h, seed,
                cfg.restir_gi, pos_prev=pos_prev, prefetch=pf_ind, **mat,
            )
        gi_sp = RG.spatial_reuse(ind_res, gb, w, h, seed, cfg.restir_gi, **mat)
        indirect = RG.shade(scene, gi_sp, gb, **mat)
    elif cfg.indirect:  # restir_di and pt: the camera rays path-traced past their first hit
        indirect = trace(scene, o, d, seed, pt_cfg, rt=rt, rows_out=True, light_sets=lsets,
                         **tex)
    if (cfg.indirect and cfg.mode in ("restir_gi", "restir_pt") and cfg.pt.sky is not None
            and not use_skydi):
        direct = direct + _sky_direct(scene, gb, cfg.pt.sky)
    hdr = (direct if indirect is None else direct + indirect).reshape(3, h, w)
    if cfg.volumetrics is not None and cfg.pt.sky is not None:
        hdr = _inscatter(scene, camera, gb, hdr, cfg)

    normal_img = gb[G.NS : G.NS + 3].reshape(3, h, w)
    depth_img = gb[G.DEPTH].reshape(h, w)
    valid_img = (gb[G.VALID] > 0.5).reshape(h, w)
    if cfg.firefly_factor > 0.0:
        hdr = DN.firefly_filter_p(hdr, cfg.firefly_factor)
    if cfg.denoise:
        hdr = DN.atrous_denoise_p(hdr, normal_img, depth_img, valid_img)
    pos_img = (gb[G.POS : G.POS + 3] if pos_prev is None else pos_prev.T).reshape(3, h, w)
    lock = None
    rcas = None
    if cfg.render_scale != 1.0:
        # the history, the last depth plane and the locks gate together
        hist = state.history if (cfg.taa and state is not None) else None
        hdr, lock = UP.taau_resolve(
            hdr, hist, pos_img, valid_img, depth_img,
            state.camera_prev if state is not None else camera, camera.jitter, cfg.width,
            cfg.height, cfg.upscale_cfg,
            prev_depth_lr=None if hist is None else state.gbuf[TG.DEPTH].reshape(h, w),
            lock=None if hist is None else state.upscale_lock,
        )
        if cfg.upscale_cfg.rcas_sharpness > 0.0:
            rcas = lambda ldr: UP.rcas_p(ldr, cfg.upscale_cfg.rcas_sharpness)
    elif cfg.taa and state is not None:
        hdr = TA.taa_resolve_p(hdr, state.history, pos_img, valid_img, state.camera_prev,
                               depth_img)

    ldr = _postprocess(hdr, cfg, rcas)
    new_state = FrameState(
        reservoirs=res, gi_reservoirs=ind_res, gbuf=pack_temporal(gb),
        camera_prev=camera, history=hdr, sky_reservoirs=sky_res, upscale_lock=lock,
    )
    return {"hdr": hdr.permute(1, 2, 0), "ldr": ldr.permute(1, 2, 0)}, new_state
