"""Application shell (ZetaLab analog): load a glTF, run the frame loop,
write frames and stats -- the JAX package's ``app.py`` on the port.

    python -m zetaray_tpu_torch.app scene.gltf --mode restir_di --frames 8 \
        --size 512x512 --out frames

The reference's WinMain is: InitAndGetInterface -> App::Init -> glTF::Load
-> App::Run (ZetaLab.cpp:33-74). As in the JAX app, this registers the
standard tweakables in ``utils.params`` (the reference's ParamVariants,
DefaultRenderer.cpp:328-430), runs the frame loop with ``FrameStats`` and
writes PNG captures (CaptureScreen analog), with each hand-written
kernel's launches in the frame stats (``launches/B1`` .. ``launches/B9``,
counted by the kernels' wrappers: 0 on the CPU, where every wrapper takes
its plain version); ``--gui PORT`` serves the
interactive viewer instead. It takes every flag of the JAX app and one
more, ``--device``: the frames run on the card (``cuda``, the default;
without CUDA the app raises) unless ``--device cpu`` is given, where every
kernel wrapper takes its plain PyTorch version. Frame i renders with the
u32 frame seed ``frame_seed(i)`` (the JAX app's ``PRNGKey(i)`` has no
counterpart in the port's random streams). ``--out`` defaults to
``zetaray_frames`` under the working directory.
"""

from __future__ import annotations

import argparse
import math
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

FRAME_SEED0 = 0x2468ACE1
RESTIR_MODES = ("restir_di", "restir_gi", "restir_pt")


def frame_seed(i: int) -> int:
    """The u32 frame seed of frame ``i`` of the app's and the viewer's loops."""
    return (FRAME_SEED0 + i) & 0xFFFFFFFF


def _register_params(cfg_holder):
    """Register the standard tweakables; each callback replaces
    ``cfg_holder[0]`` with a new RenderConfig."""
    from .ops.post import TONEMAPPERS_P
    from .utils.params import add_param

    def upd(field):
        def cb(v):
            cfg_holder[0] = replace(cfg_holder[0], **{field: v})

        return cb

    add_param("Renderer", "General", "Mode", "enum", cfg_holder[0].mode,
              choices=("pt", "restir_di", "restir_gi", "restir_pt"), on_change=upd("mode"))
    add_param("Renderer", "General", "Tonemapper", "enum", cfg_holder[0].tonemapper,
              choices=tuple(TONEMAPPERS_P), on_change=upd("tonemapper"))
    add_param("Renderer", "General", "AutoExposure", "bool", cfg_holder[0].auto_exposure,
              on_change=upd("auto_exposure"))
    add_param("Renderer", "Post", "FireflyFactor", "float", cfg_holder[0].firefly_factor,
              min=0.0, max=16.0, on_change=upd("firefly_factor"))
    add_param("Renderer", "Post", "Denoise", "bool", cfg_holder[0].denoise,
              on_change=upd("denoise"))
    add_param("Renderer", "Post", "TAA", "bool", cfg_holder[0].taa, on_change=upd("taa"))

    def upd_pt(field):
        def cb(v):
            cfg_holder[0] = replace(cfg_holder[0], pt=replace(cfg_holder[0].pt, **{field: v}))

        return cb

    add_param("PathTracer", "Path", "MaxBounces", "int", cfg_holder[0].pt.max_bounces,
              min=0, max=16, on_change=upd_pt("max_bounces"))
    add_param("PathTracer", "Path", "RussianRouletteStart", "int", cfg_holder[0].pt.rr_start,
              min=1, max=16, on_change=upd_pt("rr_start"))

    def upd_rs(field):
        def cb(v):
            cfg_holder[0] = replace(cfg_holder[0],
                                    restir=replace(cfg_holder[0].restir, **{field: v}))

        return cb

    add_param("ReSTIR", "DI", "NumCandidates", "int", cfg_holder[0].restir.num_candidates,
              min=1, max=64, on_change=upd_rs("num_candidates"))
    add_param("ReSTIR", "DI", "Temporal", "bool", cfg_holder[0].restir.temporal,
              on_change=upd_rs("temporal"))
    add_param("ReSTIR", "DI", "SpatialRadius", "int", cfg_holder[0].restir.spatial_radius,
              min=1, max=64, on_change=upd_rs("spatial_radius"))


def scene_textures(cpu, device):
    """The texture bundle of ``cpu``'s maps on ``device``, or None where no
    map decoded; logs how many of the referenced files decoded."""
    from .scene.textures import SLOTS, load_scene_textures
    from .utils import log

    bundle = load_scene_textures(cpu, device)
    n_maps = sum(len(bundle[slot]) for slot, _, _ in SLOTS)
    n_refs = len([p for p in (cpu.texture_paths or []) if p])
    if n_refs and not n_maps:
        log.warning(f"decoded none of the {n_refs} textures: the materials' factors only")
    return bundle if n_maps else None


def with_outline(ldr, state, pid: int):
    """``ldr`` [H, W, 3] uint8 with the Sobel outline of instance ``pid``
    (Display.cpp:358-398) drawn from ``state.gbuf``'s instance plane; as it
    is where that plane has another size than the image (``render_scale``
    != 1)."""
    import torch

    from .ops.gbuffer_pack import TG
    from .ops.post import picked_outline_p

    h, w = ldr.shape[:2]
    if state.gbuf.shape[1] != h * w:
        return ldr
    ldr_p = ldr.to(torch.float32).permute(2, 0, 1)
    inst_img = state.gbuf[TG.INST].reshape(h, w)
    return (picked_outline_p(ldr_p / 255.0, inst_img, pid) * 255.0).permute(1, 2, 0).to(
        torch.uint8)


def main(argv=None):
    parser = argparse.ArgumentParser(description="zetaray_tpu_torch renderer")
    parser.add_argument("scene", help="glTF/GLB scene path")
    parser.add_argument("--mode", default="restir_di",
                        choices=("pt", "restir_di", "restir_gi", "restir_pt"))
    parser.add_argument("--animate", type=float, default=0.0, metavar="FPS",
                        help="play glTF animation 0 at this frame rate "
                             "(device refit + geometry motion vectors)")
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--size", default="512x512")
    parser.add_argument("--bounces", type=int, default=4)
    parser.add_argument("--out", default="zetaray_frames")
    parser.add_argument("--eye", default="0,1,3.5")
    parser.add_argument("--target", default="0,1,0")
    parser.add_argument("--fov", type=float, default=45.0)
    parser.add_argument("--sun", default=None, help="x,y,z enables sun+sky")
    parser.add_argument("--denoise", action="store_true")
    parser.add_argument("--orbit", type=float, default=0.0,
                        help="degrees/frame camera orbit around the target")
    parser.add_argument("--dump-graph", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="print per-pass times (GpuTimer analog) before rendering")
    parser.add_argument("--tonemap", default=None,
                        help="override tonemapper (none|neutral|agx|agx_golden|agx_punchy|tony)")
    parser.add_argument("--gui", type=int, default=None, metavar="PORT",
                        help="serve the interactive viewer/editor (GuiPass analog) on this "
                             "port instead of writing frames; 0 = ephemeral port")
    parser.add_argument("--outline", default=None, metavar="NAME",
                        help="Sobel-outline the named instance in the output (restir modes; "
                             "Display.cpp picked outline)")
    parser.add_argument("--validate", action="store_true",
                        help="per-frame validation (debug-layer analog, utils/validate.py): "
                             "NaN/Inf/negative checks on the HDR output and temporal state")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without CUDA) or cpu (the plain "
                             "PyTorch versions of the kernels)")
    args = parser.parse_args(argv)

    from . import native
    from .ops.pathtracer import PTConfig
    from .ops.sky import SkyParams
    from .profile import launch_counts
    from .render.frame import RenderConfig, render_frame, render_frame_restir
    from .render.graph import frame_dag
    from .scene.camera import Camera
    from .utils import log
    from .utils.png import write_png
    from .utils.stats import stats

    device = native.default_device(None if args.device == "cuda" else args.device)
    w, h = (int(v) for v in args.size.split("x"))
    sky = None
    if args.sun:
        sky = SkyParams(sun_dir=tuple(float(v) for v in args.sun.split(",")))
    cfg = RenderConfig(
        width=w, height=h, mode=args.mode, pt=PTConfig(max_bounces=args.bounces, sky=sky),
        denoise=args.denoise, **({"tonemapper": args.tonemap} if args.tonemap else {}),
    )
    eye = tuple(float(v) for v in args.eye.split(","))
    target = tuple(float(v) for v in args.target.split(","))
    if args.gui is not None:
        # interactive viewer/editor (reference: GuiPass + imgui dock)
        from .gui import Viewer, make_server

        viewer = Viewer(args.scene, cfg, eye=eye, target=target, fov_deg=args.fov,
                        device=device)
        server = make_server(viewer, args.gui)
        log.info(f"viewer at http://127.0.0.1:{server.server_address[1]}/ (ctrl-C to stop)")
        viewer.run_in_thread()
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            viewer.stop()
        finally:
            server.server_close()
        return

    cfg_holder = [cfg]
    _register_params(cfg_holder)

    log.info(f"loading {args.scene} onto {device}")
    t0 = time.time()
    from .scene.animation import AnimationRig, transform_deltas
    from .scene.gltf import load_gltf
    from .scene.refit import refit_scene
    from .scene.scene import load_scene, upload_scene

    doc = load_gltf(args.scene)
    cpu = load_scene(doc)
    scene = upload_scene(cpu, device)
    rig = AnimationRig(doc) if args.animate else None
    if rig is not None and not rig.animated:
        log.warning("--animate given but the scene has no animations")
        rig = None
    textures = scene_textures(cpu, device)
    if textures and textures["emissive"] and scene.num_emissives > 0:
        # PreLighting round trip: device power estimate -> host alias
        # rebuild -> device tables (reference PreLighting.cpp:354-546)
        from .ops.prelighting import apply_tri_powers, estimate_tri_power

        scene = apply_tri_powers(scene, *estimate_tri_power(scene, textures))
        log.info("emissive power re-estimated from textures")
    log.info(f"scene: {cpu.num_tris} tris, {len(cpu.emissive_tris)} emissive "
             f"({time.time() - t0:.2f}s)")
    cam0 = Camera.look_at(eye, target, vfov_deg=args.fov, aspect=w / h)

    if args.dump_graph:
        print(frame_dag(cfg_holder[0]))

    if args.profile:
        from .profile import time_passes

        log.info("profiling passes (each stage synchronised; see profile.py)")
        for name, ms in time_passes(scene, cam0, cfg, textures=textures).items():
            print(f"  {name}: {ms:.2f} ms")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    from .utils.params import registry

    state = None
    for i in range(args.frames):
        registry.apply_pending()
        cfg = cfg_holder[0]
        stats.begin_frame()
        launched = launch_counts()
        if args.orbit:
            ang = math.radians(args.orbit * i)
            rel = np.asarray(eye) - np.asarray(target)
            rot = np.array([[math.cos(ang), 0, math.sin(ang)], [0, 1, 0],
                            [-math.sin(ang), 0, math.cos(ang)]])
            cam0 = Camera.look_at(tuple(np.asarray(target) + rot @ rel), target,
                                  vfov_deg=args.fov, aspect=w / h)
        cam = cam0.with_jitter(i)
        frame_scene, motion = scene, None
        if rig is not None:
            # SceneCore animation update + TLAS refit analog, on the device
            t = i / args.animate
            w_curr = rig.instance_worlds(t)
            frame_scene = refit_scene(scene, *rig.deltas(t))
            w_prev = rig.instance_worlds(max(t - 1.0 / args.animate, 0.0))
            motion, _ = transform_deltas(w_curr, w_prev)
        if cfg.mode in RESTIR_MODES and scene.num_emissives > 0:
            out, state = render_frame_restir(frame_scene, cam, frame_seed(i), cfg, state,
                                             textures, motion=motion)
        else:
            out = render_frame(frame_scene, cam, frame_seed(i), cfg)
        if args.outline and state is not None:
            names = [n for n in cpu.inst_names if args.outline in n]
            if names:
                out["ldr"] = with_outline(out["ldr"], state, cpu.inst_names.index(names[0]))
        if args.validate:
            from .utils.validate import check_frame

            check_frame(out, state)
        ldr = out["ldr"].cpu().numpy()  # waits for the frame
        stats.add("frame", "mean_radiance", float(out["hdr"].mean()))
        for tag, n in launch_counts().items():
            stats.add("launches", tag, n - launched[tag])
        dt = stats.end_frame()
        write_png(str(out_dir / f"frame_{i:04d}.png"), ldr)
        log.info(f"frame {i}: {dt * 1000:.1f} ms")
    print(stats.report())
    log.info(f"wrote {args.frames} frames to {out_dir}")


if __name__ == "__main__":
    main()
