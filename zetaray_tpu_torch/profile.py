"""Where a frame's time goes on the card.

    python -m zetaray_tpu_torch.profile [--frames 6] [--out profile.json] [--paths ...]

For each path -- on the procedural Cornell box the flagship ReSTIR GI frame
at 512^2 and 1920x1080 (max_bounces 3 and 2), the ReSTIR PT frame at 512^2,
the plain path-traced frame at 512^2 (max_bounces 4), the JAX app's
default frame (mode="restir_di", max_bounces 4, TAA) at 512^2 without and
with its sun and sky, bench.py's features frame (light-voxel-grid DI
candidates, pairwise MIS, SkyDI, froxel volumetrics) at 256^2 as it stands
and at 512^2 with the sun in through the box's opening, and bench.py's
upscale_256_to_512 (ReSTIR GI, max_bounces 2, rendered at 256^2, the
temporal upscaler to 512^2 and RCAS) beside its native 512^2 twin, and the
flagship on the materials box (a glass block and a clear-coated block)
without and with ``full_target=True`` and ``packed_reuse=False`` in every
ReSTIR config, the flagship and the default frame on the textured box
(its maps written into the package's ``_build/textures``; the bundle after
the emissive power round trip) and the flagship on the cutout box; and on the box
split to 139,266 triangles (clustered: every ray query through B8/B9) the
ReSTIR GI frame (max_bounces 2) and the ReSTIR PT frame (max_bounces 3) at
256^2, each with a-trous and TAA where the frame has them -- it measures:

- frame: host clock around each of ``--frames`` chained frames, each ending
  in ``torch.cuda.synchronize()``; the median of frames 2 on (the first has
  no temporal reuse and no TAA), and the SM clock and power draw that
  ``nvidia-smi`` reads just after;
- passes: the same chain again with each stage function the frame calls
  wrapped in a synchronise and the host clock (a stage called inside
  another counts in the outer one), the median per pass over frames 2 on
  (the synchronises add their own cost). RCAS runs inside the post chain
  and is timed on its own row, not in the post chain's;
- device: ``torch.profiler`` over 3 more chained frames, after a first
  frame that is traced and dropped (it starts the trace and the chain):
  kernel launches and device kernel time per frame, each hand-written
  kernel's time per frame and per launch (every launch of the profiled
  frames, in order; their number must equal the launches its wrapper
  counted), and the device's idle share, 1 - kernel time / the frame
  median.

It prints one JSON object and writes it to ``--out``. It needs a CUDA card.

Two public functions serve the app and the viewer, as the JAX package's
``render/profile.py`` does: ``time_passes(scene, camera, cfg)`` -> {pass:
ms}, the per-pass medians above of a short chain on the scene's device
(it synchronises only on a CUDA device), and ``trace_frame(trace_dir, fn,
*args)``, which runs one call under ``torch.profiler`` and writes its
Chrome trace into ``trace_dir``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import statistics
import subprocess
import time
from collections import defaultdict

import torch

from .accel import intersect as XI
from .accel import megakernel as MK
from .accel import stream as ST
from .ops import prelighting as PL
from .ops import restir_di as RD
from .ops import restir_gi as RG
from .ops import restir_pt as RP
from .ops import upscale as UP
from .ops import volumetrics as VL
from .ops.pathtracer import PTConfig
from .ops.skydi import SkyDIConfig
from .ops.sky import SkyParams
from .render import frame as F
from .scene.camera import Camera
from .scene import textures as TX
from .scene.procedural import (
    CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box, cutout_box, materials_box, textured_box,
)
from .scene.scene import upload_scene
from .scene.subdivide import subdivide_scene
from .timing import card_line

# (module, attribute, pass name): the stage functions the frames call
STAGES = [
    (F, "gbuffer", "G-buffer (B1; clustered B8)"), (F, "build_light_sets", "light sets"),
    (TX, "apply_textures_to_gbuffer", "G-buffer textures"),
    (MK, "fetch_base", "texture fetch between B4 and B5"),
    (RD, "reproject_prev", "joint temporal gather"), (RD, "take_multi", "joint temporal gather"),
    (RD, "initial_candidates", "DI RIS (B2)"),
    (PL, "build_light_voxel_grid", "light voxel grid build"),
    (RD, "lvg_merge", "DI grid candidates"), (RD, "temporal_reuse", "DI temporal reuse"),
    (RD, "visibility_reuse", "DI visibility (B3; clustered B9)"),
    (RD, "spatial_reuse", "DI spatial reuse"), (RD, "shade", "DI shade (B3; clustered B9)"),
    (RG, "initial_samples", "GI initial samples (B4-B6; clustered B8, B9)"),
    (RG, "temporal_reuse", "GI temporal reuse"), (RG, "spatial_reuse", "GI spatial reuse"),
    (RG, "shade", "GI shade (B3; clustered B9)"),
    (RP, "initial_samples", "PT initial samples (B7 x2, B6)"),
    (RP, "temporal_reuse", "PT temporal reuse (replay: B7)"),
    (RP, "spatial_reuse", "PT spatial reuse (replay: B7)"), (RP, "shade", "PT shade (B3)"),
    (F, "trace", "path trace (B6; clustered B8, B9)"),
    (F, "_sky_direct", "sky background + primary sun NEE (B3; clustered B9)"),
    (F, "_skydi", "SkyDI (B3; clustered B9)"),
    (VL, "build_froxels", "froxel build (B3; clustered B9)"),
    (VL, "apply_inscattering", "froxel compositing"),
    (F.DN, "atrous_denoise_p", "a-trous"), (F.TA, "taa_resolve_p", "TAA"),
    (UP, "taau_resolve", "TAAU (temporal upscaler)"), (UP, "rcas_p", "RCAS"),
    (F, "_postprocess", "exposure + AgX + sRGB"), (F, "pack_temporal", "pack temporal G-buffer"),
]
# stages timed on their own rows even inside another stage, whose row they
# leave. It holds RCAS alone: RCAS runs inside the post chain, as the
# ``ldr_transform`` that ``_postprocess`` applies after the tonemap
NESTED = {"RCAS", "texture fetch between B4 and B5"}
KERNELS = {"gbuffer_kernel": "B1", "ris_kernel": "B2", "occlusion_kernel": "B3",
           "bounce_trace_kernel": "B4", "bounce_shade_kernel": "B5", "bounce_kernel": "B6",
           "closest_kernel": "B7", "stream_closest_kernel": "B8",
           "stream_any_hit_kernel": "B9"}
# (module, wrapper) of each kernel: the wrapper counts its launches
LAUNCHERS = {"B1": (MK, "gbuffer"), "B2": (RD, "initial_candidates"), "B3": (XI, "occlusion"),
             "B4": (MK, "bounce_trace"), "B5": (MK, "bounce_shade"), "B6": (MK, "bounce"),
             "B7": (XI, "closest_hit"), "B8": (ST, "stream_closest"),
             "B9": (ST, "occlusion_stream")}


def launch_counts() -> dict:
    """{B1..B9: launches so far} as each kernel's wrapper counts them."""
    return {tag: getattr(m, a).launches for tag, (m, a) in LAUNCHERS.items()}


# the scenes of the paths, made in a directory for texture maps: the box, the
# materials, textured and cutout boxes, and the box split past the dense limit
SCENES = {"box": lambda _: cornell_box(), "materials": lambda _: materials_box(),
          "textured": textured_box, "cutout": cutout_box,
          "box139k": lambda _: subdivide_scene(cornell_box(), 100_000)}


def _paths():
    """{path: (scene name, camera, RenderConfig)}."""
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    cam_hd = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1920 / 1080)
    post = dict(denoise=True, taa=True)
    return {
        "restir_gi_512": ("box", cam, F.RenderConfig(mode="restir_gi",
                                                     pt=PTConfig(max_bounces=3), **post)),
        "restir_gi_1080p": ("box", cam_hd, F.RenderConfig(
            width=1920, height=1080, mode="restir_gi", pt=PTConfig(max_bounces=2), **post)),
        "restir_pt_512": ("box", cam, F.RenderConfig(mode="restir_pt",
                                                     pt=PTConfig(max_bounces=3), **post)),
        "pt_512": ("box", cam, F.RenderConfig(mode="pt", pt=PTConfig(max_bounces=4))),
        "restir_di_512": ("box", cam, F.RenderConfig(mode="restir_di",
                                                     pt=PTConfig(max_bounces=4), taa=True)),
        "restir_di_sky_512": ("box", cam, F.RenderConfig(mode="restir_di", taa=True, pt=PTConfig(
            max_bounces=4, sky=SkyParams(sun_dir=(0.2, 0.45, 0.87))))),
        "features_256": ("box", cam, _features(256, (0.3, 0.8, 0.2))),
        "features_sun_512": ("box", cam, _features(512, (0.2, 0.45, 0.87))),
        "upscale_256_to_512": ("box", cam, _upscale(0.5)),
        "upscale_native_512": ("box", cam, _upscale(1.0)),
        "materials_gi_512": ("materials", cam, F.RenderConfig(
            mode="restir_gi", pt=PTConfig(max_bounces=3), **post)),
        "materials_gi_options_512": ("materials", cam, F.RenderConfig(
            mode="restir_gi", pt=PTConfig(max_bounces=3), **post, **_reuse_options())),
        "textured_gi_512": ("textured", cam, F.RenderConfig(
            mode="restir_gi", pt=PTConfig(max_bounces=3), **post)),
        "textured_restir_di_512": ("textured", cam, F.RenderConfig(
            mode="restir_di", pt=PTConfig(max_bounces=4), taa=True)),
        "cutout_gi_512": ("cutout", cam, F.RenderConfig(
            mode="restir_gi", pt=PTConfig(max_bounces=3), **post)),
        "clustered_gi_256": ("box139k", cam, F.RenderConfig(
            width=256, height=256, mode="restir_gi", pt=PTConfig(max_bounces=2), **post)),
        "clustered_pt_256": ("box139k", cam, F.RenderConfig(
            width=256, height=256, mode="restir_pt", pt=PTConfig(max_bounces=3), **post)),
    }


def _features(res: int, sun_dir) -> F.RenderConfig:
    """bench.py's features frame at res^2 with the sun toward ``sun_dir``."""
    return F.RenderConfig(
        width=res, height=res, mode="restir_gi",
        pt=PTConfig(max_bounces=2, sky=SkyParams(sun_dir=sun_dir), stochastic_multi_bounce=True,
                    path_regularization=True),
        restir=RD.ReSTIRConfig(lvg_samples=2, spatial_mis="pairwise"),
        restir_gi=RG.ReSTIRGIConfig(boiling_suppression=True), skydi=True,
        skydi_cfg=SkyDIConfig(spatial_mis="pairwise"), volumetrics=VL.VolumetricsConfig(),
        denoise=True, taa=True)


def _reuse_options() -> dict:
    """``full_target=True`` and ``packed_reuse=False`` in every ReSTIR config."""
    kw = dict(full_target=True, packed_reuse=False)
    return dict(restir=RD.ReSTIRConfig(**kw), restir_gi=RG.ReSTIRGIConfig(**kw),
                restir_pt=RP.ReSTIRPTConfig(**kw))


def _upscale(render_scale: float) -> F.RenderConfig:
    """bench.py's upscale_256_to_512 (bench.py:178-183) at ``render_scale``."""
    return F.RenderConfig(width=512, height=512, mode="restir_gi", pt=PTConfig(max_bounces=2),
                          render_scale=render_scale, taa=True,
                          upscale_cfg=UP.UpscaleConfig(rcas_sharpness=0.8))


def _load(name: str, tex_dir: str):
    """(scene, texture bundle or None) of SCENES[name] on the card; a scene
    with texture maps gets its bundle and, with an emissive map, the
    emissive power round trip."""
    cpu = SCENES[name](tex_dir)
    scene = upload_scene(cpu)
    if not cpu.texture_paths:
        return scene, None
    tex = TX.load_scene_textures(cpu)
    if tex["emissive"]:
        scene = PL.apply_tri_powers(scene, *PL.estimate_tri_power(scene, tex))
    return scene, tex


def _chain(scene, cam, cfg, frames, seed=0x2468ACE1, after=None, textures=None):
    """Chained frames; returns each frame's ms (host clock, synchronised).
    ``after(k)`` runs after frame k, outside its time."""
    state, times = None, []
    for k in range(frames):
        t = time.perf_counter()
        if cfg.mode == "pt":
            F.render_frame(scene, cam.with_jitter(k), seed + k, cfg)
        else:
            _, state = F.render_frame_restir(scene, cam.with_jitter(k), seed + k, cfg, state,
                                             textures=textures)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if after is not None:
            after(k)
    return times


def _sync(device) -> None:
    """Wait for the work queued on ``device``: a no-op on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _passes(scene, cam, cfg, frames, textures=None, seed=0x2468ACE1):
    """Median ms per pass over frames 2 on, each stage synchronised."""
    spent = defaultdict(lambda: [0.0] * frames)
    frame_no, stack = [0], []
    dev = scene.device

    def wrap(fn, name):
        @functools.wraps(fn)
        def timed(*a, **kw):
            if stack and name not in NESTED:
                return fn(*a, **kw)
            stack.append(name)
            _sync(dev)
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                _sync(dev)
                ms = (time.perf_counter() - t) * 1e3
                stack.pop()
                spent[name][frame_no[0]] += ms
                if stack:  # a NESTED stage leaves its enclosing stage's row
                    spent[stack[-1]][frame_no[0]] -= ms
        return timed

    saved = [(m, a, getattr(m, a)) for m, a, _ in STAGES]
    for (m, a, name), (_, _, fn) in zip(STAGES, saved):
        setattr(m, a, wrap(fn, name))
    try:
        state = None
        for k in range(frames):
            frame_no[0] = k
            if cfg.mode == "pt":
                F.render_frame(scene, cam.with_jitter(k), seed + k, cfg)
            else:
                _, state = F.render_frame_restir(scene, cam.with_jitter(k), seed + k, cfg,
                                                 state, textures=textures)
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
    rows = {name: statistics.median(v[1:]) for name, v in spent.items()}
    return dict(sorted(rows.items(), key=lambda kv: -kv[1]))


def time_passes(scene, camera, cfg, seed: int = 0x2468ACE1, reps: int = 10,
                textures=None) -> dict:
    """{pass: ms} of ``cfg``'s frame on ``scene.device``: ``reps`` + 1
    chained frames from frame seed ``seed``, each stage function the frame
    calls wrapped in the host clock (and, on a CUDA device, a synchronise
    each side), the median per pass over all frames but the first (which
    has no temporal reuse and no TAA), largest first. The synchronises add
    their own cost, so the sum exceeds the frame's time."""
    return _passes(scene, camera, cfg, reps + 1, textures=textures, seed=seed)


def profiled(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under ``torch.profiler`` (the CPU, and the
    card where there is one), synchronising the card before the profile
    closes. Returns (the profile, fn's result)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return prof, out


def trace_frame(trace_dir: str, fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under ``profiled`` and write the trace
    into ``trace_dir`` as ``trace.json`` (Chrome trace format: open it in
    Perfetto). Returns fn's result."""
    prof, out = profiled(fn, *args, **kwargs)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return out


def _kernel_tag(name: str):
    """B1-B9 for a hand-written kernel's event name, else None. Whole names:
    B7's closest_kernel ends B8's stream_closest_kernel."""
    for kernel, tag in KERNELS.items():
        if re.search(rf"(?<![A-Za-z_]){kernel}", name):
            return tag
    return None


def _device(scene, cam, cfg, frame_ms, frames=3, textures=None):
    """Kernel launches, device kernel time and idle share per frame, over
    ``frames`` chained frames after a first one that is traced and dropped."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=frames, repeat=1)

    def step(k):
        if k == 0:  # the profiled frames start here
            for m, a in LAUNCHERS.values():
                getattr(m, a).launches = 0
        prof.step()

    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        _chain(scene, cam, cfg, frames + 1, after=step, textures=textures)
    counted = launch_counts()
    launches, copies, kernel_us, ours = 0, 0, 0.0, defaultdict(float)
    # each launch of a hand-written kernel, in launch order: the same kernel
    # serves several passes of a frame on inputs of different cost
    each = defaultdict(list)
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        tag = _kernel_tag(ev.name) if ev.device_type == torch.autograd.DeviceType.CUDA else None
        if tag:
            each[tag].append(ev.device_time_total / 1e3)
    for ev in prof.key_averages():
        # the schedule's step annotations span each frame on the device track
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.key.startswith("ProfilerStep"):
            continue
        if ev.key.startswith(("Memcpy", "Memset")):
            copies += ev.count
            continue
        launches += ev.count
        kernel_us += ev.self_device_time_total
        tag = _kernel_tag(ev.key)
        if tag:
            ours[tag] += ev.self_device_time_total / frames / 1e3
    traced = {tag: len(x) for tag, x in each.items()}
    if traced != {tag: k for tag, k in counted.items() if k}:
        raise AssertionError(f"the trace holds {traced} launches of the hand-written kernels; "
                             f"their wrappers counted {counted}")
    kernel_ms = kernel_us / frames / 1e3
    return dict(launches_per_frame=launches / frames, copies_per_frame=copies / frames,
                kernel_ms_per_frame=kernel_ms, idle_share=1.0 - kernel_ms / frame_ms,
                hand_written_launches=dict(sorted(traced.items())),
                hand_written_ms_per_frame=dict(sorted(ours.items())),
                hand_written_ms_each_launch=dict(sorted(each.items())))


def _clocks() -> str:
    """The card's SM clock (MHz) and power draw (W) just after a chain."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--out", default="profile.json")
    ap.add_argument("--paths", default=",".join(_paths()))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: CUDA is not available")
    card = card_line()
    tex_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build", "textures")
    os.makedirs(tex_dir, exist_ok=True)
    scenes = {}
    result = {"card": card, "kind": torch.cuda.get_device_name(0), "paths": {}}
    for name in args.paths.split(","):
        scene_name, cam, cfg = _paths()[name]
        if scene_name not in scenes:
            scenes[scene_name] = _load(scene_name, tex_dir)
        scene, tex = scenes[scene_name]
        times = _chain(scene, cam, cfg, args.frames, textures=tex)
        frame_ms = statistics.median(times[1:])
        result["paths"][name] = dict(
            frames_ms=times, frame_ms=frame_ms, clocks=_clocks(),
            passes_ms=_passes(scene, cam, cfg, args.frames, textures=tex),
            device=_device(scene, cam, cfg, frame_ms, textures=tex),
        )
        print(name, json.dumps(result["paths"][name]), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
