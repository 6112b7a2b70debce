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
function does. An unknown mode or tonemapper raises ``ValueError``.

Row bands: with ``shard`` (``parallel.halo.ShardCtx``) the call renders
this rank's band of the rendered rows, as the JAX frame's ``shard``
branches do (``parallel.mesh.render_frame_restir_sharded`` makes the
context). Every random stream and light-set pick takes global pixel ids
(``pix0``, ``pix``); every reuse pass gathers from its tables extended by
halo rows (the temporal passes by ``shard.halo`` rows of the previous
frame's tables, each spatial pass by its radius); the firefly filter and
a-trous extend the image circularly, TAA, the upscaler and RCAS with
edge-clamped rows; the exposure sums the ranks' statistics. The joint
temporal gather serves the whole image only. A band then equals those
rows of the whole frame wherever ``pick_rt`` gives the band the image's
tile width (and reuse stays within the halo). ``FrameState`` holds the
band's tables, and the history and locks of its display rows.

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

Each call is one frame of the span recorder ``utils.stats.stats``: every
pass, and the code between passes that launches device work, runs inside
a span ``<layer>:<pass>`` (layers ``frame``, ``reuse``, ``post``; a pass
that ``rtbench/layers/*.json`` lists takes that file's label), and the
call commits the frame's host ms per span, and under a profiler its syncs.

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
from ..parallel import halo as HX
from ..parallel.halo import ShardCtx
from ..scene.camera import Camera
from ..utils.stats import framed, stats


MODES = ("pt", "restir_di", "restir_gi", "restir_pt")
# the post chain's span (``rtbench/layers/post.json`` labels the pass so)
POST_CHAIN = "post:exposure + tonemap + sRGB (RCAS after an upscale)"


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


def _postprocess(hdr, cfg: RenderConfig, ldr_transform=None, shard=None):
    """Planar [3, H, W] linear radiance -> [3, H, W] uint8 sRGB.
    ``ldr_transform``: applied after the tonemap (RCAS after an upscale).
    ``shard``: ``hdr`` is a row band; the exposure reduces over the ranks."""
    if not cfg.auto_exposure:
        exposure = cfg.manual_exposure
    elif cfg.exposure_mode == "weighted_avg":
        exposure, _ = post.weighted_avg_exposure_p(hdr, shard=shard)
    else:
        exposure = post.histogram_exposure_p(hdr, shard=shard)
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


def _inscatter(scene, camera, gb, hdr, cfg: RenderConfig, row0: int = 0, height=None):
    """hdr [3, h, w] (a band from image row ``row0`` of a ``height``-row
    image) through the froxel grid of this frame's camera."""
    with stats.span("frame:froxel build (B9)"):
        froxels = VL.build_froxels(scene, camera, cfg.pt.sky, cfg.volumetrics)
    h, w = hdr.shape[1:]
    with stats.span("frame:froxel compositing"):
        return VL.apply_inscattering(hdr, gb, camera, froxels, cfg.volumetrics, w,
                                     h if height is None else height, row0)


def _skydi(scene, gb, state, w, h, seed, cfg: RenderConfig, pos_prev, band):
    """SkyDI's direct light ([3, N]) and the pre-spatial reservoirs the next
    frame reuses. ``band``: the frame's rows (``_Band``)."""
    sky, sd_cfg = cfg.pt.sky, cfg.skydi_cfg
    mat = dict(trans=scene.has_transmission, coat=scene.has_coat)
    sky_res = SD.initial_candidates(gb, sky, seed, sd_cfg, pix=band.pix, **mat)
    if sd_cfg.temporal and state is not None and state.sky_reservoirs is not None:
        sky_res = SD.temporal_reuse(sky_res, band.prev(state.sky_reservoirs),
                                    band.prev(state.gbuf), gb, state.camera_prev, w, h, seed,
                                    sd_cfg, sky, pos_prev=pos_prev, **band.temporal(), **mat)
    sky_sp = SD.spatial_reuse(sky_res, gb, w, h, seed, sd_cfg, pix=band.pix, ext=band.ext,
                              **mat)
    return SD.shade(scene, sky_sp, gb, **mat), sky_res


class _Band:
    """The rows that one call of ``render_frame_restir`` renders: the whole
    ``w`` x ``h`` image, or with ``shard`` (``parallel.halo.ShardCtx``) this
    rank's band of ``shard.h_local`` rows. It hands the passes their global
    pixel ids (``pix``, None for the whole image) and their halo exchanges
    (identities for the whole image)."""

    def __init__(self, shard, w: int, h: int, device):
        self.shard, self.w = shard, w
        if shard is None:
            self.row0, self.rows, self.pix, self.halo = 0, h, None, 0
            return
        if not isinstance(shard, ShardCtx):
            raise TypeError(f"shard must be a parallel.halo.ShardCtx, not {type(shard)!r}")
        if shard.h_local * shard.n_shards != h:
            raise ValueError(f"{shard.n_shards} bands of {shard.h_local} rows do not make the "
                             f"{h} rendered rows")
        self.row0, self.rows, self.halo = shard.row0, shard.h_local, shard.halo
        self.pix = torch.arange(self.rows * w, dtype=torch.int64, device=device) + self.pix0

    @property
    def pix0(self) -> int:
        return self.row0 * self.w

    def ext(self, x, halo: int):
        """SoA rows [R, rows * w] and their halo of ``halo`` rows: (the band
        extended, the image row of its first row)."""
        if self.shard is None:
            return x, 0
        return HX.halo_exchange_flat(x, self.w, halo, self.shard), self.row0 - halo

    def prev(self, x):
        """A previous frame's table extended by the temporal halo."""
        return self.ext(x, self.halo)[0]

    def temporal(self) -> dict:
        """The temporal passes' row hooks for tables from ``prev``."""
        return dict(pix=self.pix, prev_row0=self.row0 - self.halo,
                    prev_rows=self.rows + 2 * self.halo)

    def rows_ext(self, x, halo: int, row_axis: int, clamped: bool = False):
        """An image band extended by ``halo`` rows along ``row_axis``
        (circular, or edge-clamped at the image's first and last rows)."""
        fn = HX.halo_exchange_rows_clamped if clamped else HX.halo_exchange_rows
        return fn(x, halo, self.shard, row_axis)


@framed
def render_frame(scene, camera: Camera, seed: int, cfg: RenderConfig):
    """One plain path-traced frame on ``scene.device``: {"hdr": [H, W, 3]
    float32, "ldr": [H, W, 3] uint8}. ``seed`` is the u32 frame seed. The
    camera rays are path-traced by B6 with ``cfg.pt`` whatever ``cfg.mode``
    says. Like the JAX function it renders at the display size (no
    upscaler)."""
    cfg.check_ported()
    w, h = cfg.width, cfg.height
    with stats.span("frame:camera rays"):
        o, d = camera.generate_rays(w, h, _lens_u(camera, seed, w * h, scene.device),
                                    device=scene.device)
    with stats.span("frame:path trace (B8, B9)"):
        hdr = trace(scene, o, d, seed, cfg.pt, rows_out=True).reshape(3, h, w)
    if cfg.volumetrics is not None and cfg.pt.sky is not None:
        with stats.span("frame:G-buffer (B8)"):
            gb = gbuffer(scene, o, d)
        hdr = _inscatter(scene, camera, gb, hdr, cfg)
    with stats.span(POST_CHAIN):
        ldr = _postprocess(hdr, cfg)
    return {"hdr": hdr.permute(1, 2, 0), "ldr": ldr.permute(1, 2, 0)}


@framed
def render_frame_restir(scene, camera: Camera, seed: int, cfg: RenderConfig,
                        state: FrameState | None, textures=None, motion=None, shard=None):
    """One frame on ``scene.device``: returns ({"hdr": [H, W, 3] float32,
    "ldr": [H, W, 3] uint8}, FrameState) at the display size.
    ``seed`` is the u32 frame seed; ``textures``: a texture bundle on the
    scene's device; ``motion``: [I+1, 3, 4] curr -> prev instance transforms
    (module docstring). ``shard`` (``parallel.halo.ShardCtx``): this rank
    renders its band of the rendered rows and returns its band of the
    outputs and of the state; ``state`` is then its band too (module
    docstring)."""
    from ..scene.textures import apply_textures_to_gbuffer

    cfg.check_ported()
    w, h = cfg.render_size()
    dev = scene.device
    with stats.span("frame:camera rays"):
        band = _Band(shard, w, h, dev)
        if shard is not None and cfg.render_scale != 1.0 and cfg.height % shard.n_shards:
            raise ValueError(f"{cfg.height} display rows do not split into {shard.n_shards} bands")
        h_loc, row0, pix0, pix = band.rows, band.row0, band.pix0, band.pix
        lens = _lens_u(camera, seed, w * h, dev)  # drawn by global pixel id
        if lens is not None:
            lens = lens[pix0 : pix0 + h_loc * w]
        o, d = camera.generate_rays(w, h, lens, device=dev, rows=(row0, h_loc))
    rt = pick_rt(h_loc * w)

    with stats.span("frame:G-buffer (B8)"):
        gb = gbuffer(scene, o, d)
    spread = camera.pixel_spread_angle(h)
    tex = dict(textures=textures, spread_angle=spread)
    if textures:
        with stats.span("frame:G-buffer textures"):
            gb = apply_textures_to_gbuffer(gb, textures, spread_angle=spread)
    pos_prev = None
    if motion is not None:
        with stats.span("frame:motion"):
            pos_prev = _prev_positions(gb, motion)
    with stats.span("frame:light sets"):
        lsets = build_light_sets(scene, seed)
    mat = dict(trans=scene.has_transmission, coat=scene.has_coat)
    pt_mode = cfg.mode == "restir_pt"
    ind_cfg = cfg.restir_pt if pt_mode else cfg.restir_gi
    pack_ind, unpack_ind = (pack_pt, unpack_pt) if pt_mode else (pack_di, unpack_di)

    # Joint temporal gather (GI and PT modes, both passes gathering packed;
    # the whole image only): the DI and indirect reservoirs and the packed
    # temporal G-buffer reproject alike, so one reprojection and one gather
    # serve both temporal passes. A row band runs each temporal pass on its
    # halo-extended tables (``band.prev``), as the JAX frame does.
    pf_di = pf_ind = None
    if (shard is None and state is not None and cfg.indirect and cfg.restir.temporal
            and ind_cfg.temporal and cfg.restir.packed_reuse and ind_cfg.packed_reuse
            and cfg.mode in ("restir_gi", "restir_pt")):
        with stats.span("reuse:joint temporal gather"):
            idx, inside, depth_est = RD.reproject_prev(gb, state.camera_prev, w, h, pos_prev)
            p_di, p_ind, p_g = RD.take_multi(
                [pack_di(state.reservoirs), pack_ind(state.gi_reservoirs), state.gbuf], idx
            )
            pf_di = (unpack_di(p_di), p_g, inside, depth_est)
            pf_ind = (unpack_ind(p_ind), p_g, inside, depth_est)

    with stats.span("reuse:DI RIS (B2)"):
        res = RD.initial_candidates(gb, lsets, seed, rt=rt, pix0=pix0, **mat)
    gi_lvg = cfg.mode == "restir_gi" and cfg.restir_gi.lvg and cfg.indirect
    lvg = None
    if cfg.restir.lvg_samples > 0 or gi_lvg:
        with stats.span("frame:light voxel grid build"):
            lvg = PL.build_light_voxel_grid(scene, camera, seed, cfg.lvg_cfg)
    if cfg.restir.lvg_samples > 0:
        with stats.span("reuse:DI grid candidates"):
            res = RD.lvg_merge(res, gb, camera, lvg, seed, cfg.restir, cfg.lvg_cfg, pix=pix,
                               **mat)
    prev_g = None
    if state is not None:
        with stats.span("frame:halo exchange"):
            prev_g = band.prev(state.gbuf)
    if cfg.restir.temporal and state is not None:
        with stats.span("reuse:DI temporal reuse"):
            res = RD.temporal_reuse(
                res, band.prev(state.reservoirs), prev_g, gb, state.camera_prev, w, h, seed,
                cfg.restir, pos_prev=pos_prev, prefetch=pf_di, **band.temporal(), **mat,
            )
    with stats.span("reuse:DI visibility (B9)"):
        res = RD.visibility_reuse(scene, res, gb)
    with stats.span("reuse:DI spatial reuse"):
        res_sp = RD.spatial_reuse(res, gb, w, h, seed, cfg.restir, pix=pix, ext=band.ext, **mat)
    with stats.span("reuse:DI shade (B9)"):
        direct = RD.shade(scene, res_sp, gb, **mat)
    # SkyDI: the GI and PT modes take the sky's direct light from reservoirs
    use_skydi = cfg.skydi and cfg.pt.sky is not None and cfg.mode in ("restir_gi", "restir_pt")
    sky_res = None
    if use_skydi:
        with stats.span("frame:SkyDI (B9)"):
            sky_direct, sky_res = _skydi(scene, gb, state, w, h, seed, cfg, pos_prev, band)
        with stats.span("frame:compose"):
            direct = direct + sky_direct + _sky_background(gb, cfg.pt.sky)

    ind_res = None  # without an indirect pass: zeros, made with the state
    pt_cfg = replace(cfg.pt, min_emissive_bounce=2, min_nee_bounce=1)
    temporal = ind_cfg.temporal and state is not None
    indirect = None
    reuse = dict(pix=pix, ext=band.ext, **mat)
    if cfg.indirect and pt_mode:
        with stats.span("reuse:PT initial samples (B8, B9)"):
            ind_res = RP.initial_samples(scene, gb, pt_cfg, seed, cfg.restir_pt, rt,
                                         light_sets=lsets, pix0=pix0, **mat, **tex)
        if temporal:
            with stats.span("reuse:PT temporal reuse (replay: B8)"):
                ind_res = RP.temporal_reuse(
                    ind_res, band.prev(state.gi_reservoirs), prev_g, gb, state.camera_prev, w,
                    h, seed, cfg.restir_pt, scene=scene, pos_prev=pos_prev, prefetch=pf_ind,
                    **band.temporal(), **mat,
                )
        with stats.span("reuse:PT spatial reuse (replay: B8)"):
            pt_sp = RP.spatial_reuse(ind_res, gb, w, h, seed, cfg.restir_pt, scene=scene,
                                     **reuse)
        with stats.span("reuse:PT shade (B9)"):
            indirect = RP.shade(scene, pt_sp, gb, **mat)
    elif cfg.indirect and cfg.mode == "restir_gi":
        with stats.span("reuse:GI initial samples (B8, B9)"):
            ind_res = RG.initial_samples(scene, gb, pt_cfg, seed, rt, light_sets=lsets,
                                         lvg=lvg if gi_lvg else None, lvg_cam=camera,
                                         lvg_cfg=cfg.lvg_cfg,
                                         full_target=cfg.restir_gi.full_target, pix0=pix0,
                                         **mat, **tex)
        if temporal:
            with stats.span("reuse:GI temporal reuse"):
                ind_res = RG.temporal_reuse(
                    ind_res, band.prev(state.gi_reservoirs), prev_g, gb, state.camera_prev, w,
                    h, seed, cfg.restir_gi, pos_prev=pos_prev, prefetch=pf_ind,
                    **band.temporal(), **mat,
                )
        with stats.span("reuse:GI spatial reuse"):
            gi_sp = RG.spatial_reuse(ind_res, gb, w, h, seed, cfg.restir_gi, **reuse)
        with stats.span("reuse:GI shade (B9)"):
            indirect = RG.shade(scene, gi_sp, gb, **mat)
    elif cfg.indirect:  # restir_di and pt: the camera rays path-traced past their first hit
        with stats.span("frame:path trace (B8, B9)"):
            indirect = trace(scene, o, d, seed, pt_cfg, rt=rt, rows_out=True, light_sets=lsets,
                             pix0=pix0, **tex)
    sky = None
    if (cfg.indirect and cfg.mode in ("restir_gi", "restir_pt") and cfg.pt.sky is not None
            and not use_skydi):
        with stats.span("frame:sky background + primary sun NEE (B9)"):
            sky = _sky_direct(scene, gb, cfg.pt.sky)
    with stats.span("frame:compose"):
        if sky is not None:
            direct = direct + sky
        hdr = (direct if indirect is None else direct + indirect).reshape(3, h_loc, w)
    if cfg.volumetrics is not None and cfg.pt.sky is not None:
        hdr = _inscatter(scene, camera, gb, hdr, cfg, row0, h)

    with stats.span("post:guide images"):
        normal_img = gb[G.NS : G.NS + 3].reshape(3, h_loc, w)
        depth_img = gb[G.DEPTH].reshape(h_loc, w)
        valid_img = (gb[G.VALID] > 0.5).reshape(h_loc, w)
        pos_img = (gb[G.POS : G.POS + 3] if pos_prev is None else pos_prev.T).reshape(3, h_loc, w)
    if cfg.firefly_factor > 0.0:
        with stats.span("post:firefly"):
            if shard is None:
                hdr = DN.firefly_filter_p(hdr, cfg.firefly_factor)
            else:  # the 3x3 stencil on a circular 1-row halo
                hdr = DN.firefly_filter_p(band.rows_ext(hdr, 1, 1), cfg.firefly_factor)[:, 1:-1]
    if cfg.denoise:
        with stats.span("post:a-trous"):
            if shard is None:
                hdr = DN.atrous_denoise_p(hdr, normal_img, depth_img, valid_img)
            else:
                hdr = _atrous_band(band, hdr, normal_img, depth_img, valid_img)
    lock = None
    rcas = None
    if cfg.render_scale != 1.0:
        with stats.span("post:TAAU (temporal upscaler)"):
            # the history, the last depth plane and the locks gate together
            hist = state.history if (cfg.taa and state is not None) else None
            prev_depth = None if hist is None else state.gbuf[TG.DEPTH].reshape(h_loc, w)
            lock = None if hist is None else state.upscale_lock
            args = (hdr, hist, pos_img, valid_img, depth_img)
            rows = {}
            if shard is not None:
                # render-res stencils (bilinear, min/max, dilation) read 2 halo
                # rows, the display-res history and locks the temporal halo;
                # edge-clamped, as the whole image's resamplers clamp
                hs, out_rows = 2, cfg.height // shard.n_shards
                ext = lambda x, k, ax=0: None if x is None else band.rows_ext(x, k, ax, True)
                args = (ext(hdr, hs, 1), ext(hist, band.halo, 1), ext(pos_img, hs, 1),
                        ext(valid_img, hs), ext(depth_img, hs))
                prev_depth, lock = ext(prev_depth, hs), ext(lock, band.halo)
                rows = dict(out_row0=shard.rank * out_rows, out_rows=out_rows, lr_row0=row0 - hs,
                            hr_full=h, hist_row0=shard.rank * out_rows - band.halo)
            hdr, lock = UP.taau_resolve(
                *args, state.camera_prev if state is not None else camera, camera.jitter,
                cfg.width, cfg.height, cfg.upscale_cfg, prev_depth_lr=prev_depth, lock=lock,
                **rows,
            )
        if cfg.upscale_cfg.rcas_sharpness > 0.0:
            rcas = lambda ldr: _rcas(ldr, cfg.upscale_cfg.rcas_sharpness, band)
    elif cfg.taa and state is not None:
        with stats.span("post:TAA"):
            if shard is None:
                hdr = TA.taa_resolve_p(hdr, state.history, pos_img, valid_img, state.camera_prev,
                                       depth_img)
            else:
                # edge-clamped halos: one row for the dilation and the clamp,
                # the temporal halo of the history
                ext = lambda x, k, ax=0: band.rows_ext(x, k, ax, True)
                hdr = TA.taa_resolve_p(ext(hdr, 1, 1), ext(state.history, band.halo, 1),
                                       ext(pos_img, 1, 1), ext(valid_img, 1), state.camera_prev,
                                       ext(depth_img, 1), row0=row0, height_full=h,
                                       hist_row0=row0 - band.halo, ext=1)

    with stats.span(POST_CHAIN):
        ldr = _postprocess(hdr, cfg, rcas, shard)
    with stats.span("frame:FrameState packing"):
        if ind_res is None:
            ind_res = torch.zeros_like(res)
        with stats.span("frame:pack temporal G-buffer"):
            gbuf = pack_temporal(gb)
        new_state = FrameState(
            reservoirs=res, gi_reservoirs=ind_res, gbuf=gbuf,
            camera_prev=camera, history=hdr, sky_reservoirs=sky_res, upscale_lock=lock,
        )
    return {"hdr": hdr.permute(1, 2, 0), "ldr": ldr.permute(1, 2, 0)}, new_state


def _rcas(ldr, sharpness: float, band: _Band):
    """RCAS after an upscale; on a row band, the cross stencil on an
    edge-clamped 1-row halo."""
    with stats.span("post:RCAS"):
        if band.shard is None:
            return UP.rcas_p(ldr, sharpness)
        return UP.rcas_p(band.rows_ext(ldr, 1, 1, True), sharpness)[:, 1:-1]


def _atrous_band(band: _Band, hdr, normal, depth, valid, cfg: DN.ATrousConfig = DN.ATrousConfig()):
    """``ops.denoise.atrous_denoise_p`` on a row band: each pass at tap
    spacing s reads 2 s rows beyond the band, so the guides are exchanged
    once with the widest pass's halo and the colour before each pass with
    its own (circular, as the whole image's rolls)."""
    hmax = 2 * (1 << (cfg.iterations - 1))
    h = hdr.shape[1]
    nrm = band.rows_ext(normal, hmax, 1)
    dep = band.rows_ext(depth, hmax, 0)
    val = band.rows_ext(valid, hmax, 0)
    out = hdr
    for it in range(cfg.iterations):
        step = 1 << it
        hh = 2 * step
        rows = slice(hmax - hh, hmax + h + hh)
        out = DN.atrous_iteration_p(band.rows_ext(out, hh, 1), nrm[:, rows], dep[rows],
                                    val[rows], step, cfg)[:, hh:-hh]
    return out
