"""The ReSTIR DI frame, as ``render_frame_restir`` of the JAX package's ``render/frame.py``.

The slice this package covers is the flagship frame with its indirect pass
off: ``RenderConfig(mode="restir_gi", indirect=False, denoise=True,
taa=True)``. It runs camera rays -> G-buffer -> presampled light sets ->
DI RIS -> DI temporal -> DI visibility -> DI spatial -> DI shade -> a-trous
-> TAA -> histogram exposure, AgX and sRGB, in the JAX frame's order, and
feeds the pre-spatial reservoirs forward. A setting outside the slice
raises ``NotImplementedError``.

The JAX frame's banded gathers (``band_rows``/``band_halo``) are a TPU
workaround and have no counterpart here: reuse gathers read the whole
previous frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..accel.megakernel import G, build_light_sets, gbuffer
from ..ops import denoise as DN
from ..ops import post
from ..ops import restir_di as RD
from ..ops import taa as TA
from ..ops.gbuffer_pack import pack_temporal
from ..scene.camera import Camera


@dataclass(frozen=True)
class RenderConfig:
    """Per-frame settings; field names and defaults follow the JAX package."""

    width: int = 512
    height: int = 512
    mode: str = "pt"
    restir: RD.ReSTIRConfig = field(default_factory=RD.ReSTIRConfig)
    indirect: bool = True
    skydi: bool = False
    volumetrics: object = None
    render_scale: float = 1.0
    tonemapper: str = "agx"
    auto_exposure: bool = True
    exposure_mode: str = "histogram"
    manual_exposure: float = 1.0
    firefly_factor: float = 0.0
    denoise: bool = False
    taa: bool = True

    def check_ported(self) -> None:
        """Raise for any setting this package does not implement yet."""
        later = {
            "indirect=True (ReSTIR GI, kernels B4-B6)": self.indirect,
            f"mode={self.mode!r} (plain PT and ReSTIR PT)": self.mode != "restir_gi",
            "skydi (ops.skydi)": self.skydi,
            "volumetrics (ops.volumetrics)": self.volumetrics is not None,
            "render_scale != 1 (the temporal upscaler)": self.render_scale != 1.0,
            "firefly_factor > 0 (the firefly filter)": self.firefly_factor > 0.0,
            f"exposure_mode={self.exposure_mode!r} (weighted-average exposure)":
                self.auto_exposure and self.exposure_mode != "histogram",
            f"tonemapper={self.tonemapper!r} (tonemappers other than AgX)":
                self.tonemapper != "agx",
        }
        missing = [name for name, hit in later.items() if hit]
        if missing:
            raise NotImplementedError("not ported yet: " + ", ".join(missing))


@dataclass(frozen=True)
class FrameState:
    """Temporal state carried between frames."""

    reservoirs: torch.Tensor  # [16, N] DI reservoirs (pre-spatial)
    gi_reservoirs: torch.Tensor  # [16, N] GI reservoirs (zeros: GI is not ported)
    gbuf: torch.Tensor  # [TG.ROWS, N] packed temporal G-buffer
    camera_prev: Camera
    history: torch.Tensor  # [3, H, W] TAA history (HDR)


def pick_rt(n: int) -> int:
    """The JAX frame's ray-tile width for n pixels; it fixes which light set
    each pixel's RIS draws from."""
    for rt in (1024, 512, 256, 128):
        if n % rt == 0:
            return rt
    return 1024


def render_frame_restir(scene, camera: Camera, seed: int, cfg: RenderConfig,
                        state: FrameState | None, textures=None, motion=None, shard=None):
    """One frame on ``scene.device``: returns ({"hdr": [H, W, 3] float32,
    "ldr": [H, W, 3] uint8}, FrameState). ``seed`` is the u32 frame seed."""
    cfg.check_ported()
    for name, value in (("textures", textures), ("motion", motion), ("shard", shard)):
        if value is not None:
            raise NotImplementedError(f"{name} is not ported yet")
    w, h = cfg.width, cfg.height
    dev = scene.device
    o, d = camera.generate_rays(w, h, device=dev)
    rt = pick_rt(w * h)

    gb = gbuffer(scene, o, d)
    lsets = build_light_sets(scene, seed)
    res = RD.initial_candidates(gb, lsets, seed, rt=rt)
    if cfg.restir.temporal and state is not None:
        res = RD.temporal_reuse(
            res, state.reservoirs, state.gbuf, gb, state.camera_prev, w, h, seed, cfg.restir
        )
    res = RD.visibility_reuse(scene, res, gb)
    res_sp = RD.spatial_reuse(res, gb, w, h, seed, cfg.restir)
    hdr = RD.shade(scene, res_sp, gb).reshape(3, h, w)

    normal_img = gb[G.NS : G.NS + 3].reshape(3, h, w)
    depth_img = gb[G.DEPTH].reshape(h, w)
    valid_img = (gb[G.VALID] > 0.5).reshape(h, w)
    if cfg.denoise:
        hdr = DN.atrous_denoise_p(hdr, normal_img, depth_img, valid_img)
    if cfg.taa and state is not None:
        pos_img = gb[G.POS : G.POS + 3].reshape(3, h, w)
        hdr = TA.taa_resolve_p(hdr, state.history, pos_img, valid_img, state.camera_prev,
                               depth_img)

    exposure = post.histogram_exposure_p(hdr) if cfg.auto_exposure else cfg.manual_exposure
    ldr = post.to_u8(post.srgb_encode(post.tonemap_agx_p(hdr * exposure)))
    new_state = FrameState(
        reservoirs=res, gi_reservoirs=torch.zeros_like(res), gbuf=pack_temporal(gb),
        camera_prev=camera, history=hdr,
    )
    return {"hdr": hdr.permute(1, 2, 0), "ldr": ldr.permute(1, 2, 0)}, new_state
