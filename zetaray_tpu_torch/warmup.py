"""Build everything a run compiles, then render each mode once
(PrecompileShaders analog; the counterpart of the JAX package's
``tools/warmup.py``).

    python -m zetaray_tpu_torch.warmup [--scene scene.gltf] [--size 64] [--device cuda]

The reference's Tools/PrecompileShaders compiles all its PSOs headlessly to
warm the PSO disk cache (PrecompileShaders.cpp:45-70). The port compiles
two libraries and nothing else: the CUDA kernels (``native.build``, nvcc,
on a CUDA device) and the host's BCn decoder (``native.build_bcn``, g++),
both into the package's ``_build/`` under names hashed from their sources,
where later runs find them. Then it renders each mode and the frames the
JAX tool warms (the sky, a-trous, the flagship, the features frame, the
upscaler) once at ``--size``, a ReSTIR frame twice (without and with a
temporal state), on ``--device`` (the card by default; it raises without
CUDA unless ``--device cpu``), and prints the seconds of each step. The
scene is the procedural Cornell box unless ``--scene`` names a glTF file.
"""

from __future__ import annotations

import argparse
import time


def variants(s: int) -> list:
    """The RenderConfigs the warm-up renders at s x s (the upscaler at 2s)."""
    from .ops.pathtracer import PTConfig
    from .ops.restir_di import ReSTIRConfig
    from .ops.restir_gi import ReSTIRGIConfig
    from .ops.sky import SkyParams
    from .ops.skydi import SkyDIConfig
    from .ops.upscale import UpscaleConfig
    from .ops.volumetrics import VolumetricsConfig
    from .render.frame import RenderConfig

    out = [RenderConfig(width=s, height=s, mode=mode, pt=PTConfig(max_bounces=4))
           for mode in ("pt", "restir_di", "restir_gi", "restir_pt")]
    out += [
        RenderConfig(width=s, height=s, pt=PTConfig(max_bounces=4, sky=SkyParams())),
        RenderConfig(width=s, height=s, mode="restir_di", pt=PTConfig(max_bounces=4),
                     denoise=True),
        # the flagship: DI + GI, a-trous and TAA
        RenderConfig(width=s, height=s, mode="restir_gi", pt=PTConfig(max_bounces=3),
                     denoise=True, taa=True),
        # the features frame: SkyDI, the light voxel grid, pairwise MIS, volumetrics
        RenderConfig(width=s, height=s, mode="restir_gi",
                     pt=PTConfig(max_bounces=2, sky=SkyParams(sun_dir=(0.3, 0.8, 0.2)),
                                 stochastic_multi_bounce=True, path_regularization=True),
                     restir=ReSTIRConfig(lvg_samples=2, spatial_mis="pairwise"),
                     restir_gi=ReSTIRGIConfig(boiling_suppression=True), skydi=True,
                     skydi_cfg=SkyDIConfig(spatial_mis="pairwise"),
                     volumetrics=VolumetricsConfig(), denoise=True, taa=True),
        # temporal upscaling
        RenderConfig(width=2 * s, height=2 * s, mode="restir_gi", pt=PTConfig(max_bounces=2),
                     render_scale=0.5, taa=True, upscale_cfg=UpscaleConfig(rcas_sharpness=0.8)),
    ]
    return out


def main(argv=None) -> dict:
    """Run the warm-up; returns {step: seconds}."""
    parser = argparse.ArgumentParser(description="build the port's libraries, render each mode")
    parser.add_argument("--scene", default=None, help="glTF scene (default: the Cornell box)")
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from . import native
    from .app import RESTIR_MODES
    from .render.frame import render_frame, render_frame_restir
    from .scene.camera import Camera
    from .scene.procedural import CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box
    from .scene.scene import load_scene, upload_scene

    device = native.default_device(None if args.device == "cuda" else args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    seconds = {}
    t0 = time.perf_counter()
    if device.type == "cuda":
        native.lib()
        seconds["CUDA library"] = time.perf_counter() - t0
        print(f"CUDA library: {seconds['CUDA library']:.1f} s -> {native.library_path().name}",
              flush=True)
    t0 = time.perf_counter()
    native.bcn_lib()
    seconds["BCn library"] = time.perf_counter() - t0
    print(f"BCn library: {seconds['BCn library']:.1f} s -> {native.bcn_library_path().name}",
          flush=True)
    scene = upload_scene(load_scene(args.scene) if args.scene else cornell_box(), device)
    todo = variants(args.size)
    for i, cfg in enumerate(todo):
        cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV,
                             aspect=cfg.width / cfg.height)
        t0 = time.perf_counter()
        if cfg.mode in RESTIR_MODES and scene.num_emissives > 0:
            _, st = render_frame_restir(scene, cam, 0, cfg, None)
            out, _ = render_frame_restir(scene, cam.with_jitter(1), 1, cfg, st)
        else:
            out = render_frame(scene, cam, 0, cfg)
        sync()
        if not torch.isfinite(out["hdr"]).all():
            raise RuntimeError(f"warm-up frame {i + 1} ({cfg.mode}) is not finite")
        tag = (f"[{i + 1}/{len(todo)}] {cfg.mode} {cfg.width}x{cfg.height}"
               f"{' +sky' if cfg.pt.sky else ''}{' +denoise' if cfg.denoise else ''}"
               f"{' +upscale' if cfg.render_scale != 1.0 else ''}")
        seconds[tag] = time.perf_counter() - t0
        print(f"{tag}: {seconds[tag]:.1f} s", flush=True)
    print(f"warmup complete: {sum(seconds.values()):.1f} s", flush=True)
    return seconds


if __name__ == "__main__":
    main()
