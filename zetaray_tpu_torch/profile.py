"""Where a frame's time goes on the card.

    python -m zetaray_tpu_torch.profile [--frames 6] [--out profile.json] [--paths ...]

For each path on the procedural Cornell box -- the flagship ReSTIR GI frame
at 512^2 and 1920x1080 (max_bounces 3 and 2), the ReSTIR PT frame at 512^2
and the plain path-traced frame at 512^2 (max_bounces 4), each with a-trous
and TAA where the frame has them -- it measures:

- frame: host clock around each of ``--frames`` chained frames, each ending
  in ``torch.cuda.synchronize()``; the median of frames 2 on (the first has
  no temporal reuse and no TAA);
- passes: the same chain again with each stage function the frame calls
  wrapped in a synchronise and the host clock (a stage called inside
  another counts in the outer one), the median per pass over frames 2 on
  (the synchronises add their own cost);
- device: ``torch.profiler`` over 3 more chained frames: kernel launches
  and device kernel time per frame, each hand-written kernel's time, and
  the device's idle share, 1 - kernel time / the frame median.

It prints one JSON object and writes it to ``--out``. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import time
from collections import defaultdict

import torch

from .ops import restir_di as RD
from .ops import restir_gi as RG
from .ops import restir_pt as RP
from .ops.pathtracer import PTConfig
from .render import frame as F
from .scene.camera import Camera
from .scene.procedural import CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, cornell_box
from .scene.scene import upload_scene

# (module, attribute, pass name): the stage functions the frames call
STAGES = [
    (F, "gbuffer", "G-buffer (B1)"), (F, "build_light_sets", "light sets"),
    (RD, "reproject_prev", "joint temporal gather"), (RD, "take_multi", "joint temporal gather"),
    (RD, "initial_candidates", "DI RIS (B2)"), (RD, "temporal_reuse", "DI temporal reuse"),
    (RD, "visibility_reuse", "DI visibility (B3)"), (RD, "spatial_reuse", "DI spatial reuse"),
    (RD, "shade", "DI shade (B3)"),
    (RG, "initial_samples", "GI initial samples (B4-B6)"),
    (RG, "temporal_reuse", "GI temporal reuse"), (RG, "spatial_reuse", "GI spatial reuse"),
    (RG, "shade", "GI shade (B3)"),
    (RP, "initial_samples", "PT initial samples (B7 x2, B6)"),
    (RP, "temporal_reuse", "PT temporal reuse (replay: B7)"),
    (RP, "spatial_reuse", "PT spatial reuse (replay: B7)"), (RP, "shade", "PT shade (B3)"),
    (F, "trace", "path trace (B6)"),
    (F.DN, "atrous_denoise_p", "a-trous"), (F.TA, "taa_resolve_p", "TAA"),
    (F, "_postprocess", "exposure + AgX + sRGB"), (F, "pack_temporal", "pack temporal G-buffer"),
]
KERNELS = {"gbuffer_kernel": "B1", "ris_kernel": "B2", "occlusion_kernel": "B3",
           "bounce_trace_kernel": "B4", "bounce_shade_kernel": "B5", "bounce_kernel": "B6",
           "closest_kernel": "B7"}


def _paths():
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1.0)
    cam_hd = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=1920 / 1080)
    post = dict(denoise=True, taa=True)
    return {
        "restir_gi_512": (cam, F.RenderConfig(mode="restir_gi", pt=PTConfig(max_bounces=3),
                                              **post)),
        "restir_gi_1080p": (cam_hd, F.RenderConfig(width=1920, height=1080, mode="restir_gi",
                                                   pt=PTConfig(max_bounces=2), **post)),
        "restir_pt_512": (cam, F.RenderConfig(mode="restir_pt", pt=PTConfig(max_bounces=3),
                                              **post)),
        "pt_512": (cam, F.RenderConfig(mode="pt", pt=PTConfig(max_bounces=4))),
    }


def _chain(scene, cam, cfg, frames, seed=0x2468ACE1):
    """Chained frames; returns each frame's ms (host clock, synchronised)."""
    state, times = None, []
    for k in range(frames):
        t = time.perf_counter()
        if cfg.mode == "pt":
            F.render_frame(scene, cam.with_jitter(k), seed + k, cfg)
        else:
            _, state = F.render_frame_restir(scene, cam.with_jitter(k), seed + k, cfg, state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def _passes(scene, cam, cfg, frames):
    """Median ms per pass over frames 2 on, each stage synchronised."""
    spent = defaultdict(lambda: [0.0] * frames)
    frame_no, depth = [0], [0]

    def wrap(fn, name):
        @functools.wraps(fn)
        def timed(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                spent[name][frame_no[0]] += (time.perf_counter() - t) * 1e3
                depth[0] -= 1
        return timed

    saved = [(m, a, getattr(m, a)) for m, a, _ in STAGES]
    for (m, a, name), (_, _, fn) in zip(STAGES, saved):
        setattr(m, a, wrap(fn, name))
    try:
        state = None
        for k in range(frames):
            frame_no[0] = k
            if cfg.mode == "pt":
                F.render_frame(scene, cam.with_jitter(k), 0x2468ACE1 + k, cfg)
            else:
                _, state = F.render_frame_restir(scene, cam.with_jitter(k), 0x2468ACE1 + k, cfg,
                                                 state)
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
    rows = {name: statistics.median(v[1:]) for name, v in spent.items()}
    return dict(sorted(rows.items(), key=lambda kv: -kv[1]))


def _device(scene, cam, cfg, frame_ms, frames=3):
    """Kernel launches, device kernel time and idle share per frame."""
    _chain(scene, cam, cfg, 2)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _chain(scene, cam, cfg, frames)
    launches, copies, kernel_us, ours = 0, 0, 0.0, defaultdict(float)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if ev.key.startswith(("Memcpy", "Memset")):
            copies += ev.count
            continue
        launches += ev.count
        kernel_us += ev.self_device_time_total
        for name, tag in KERNELS.items():
            if name in ev.key:
                ours[tag] += ev.self_device_time_total / frames / 1e3
    kernel_ms = kernel_us / frames / 1e3
    return dict(launches_per_frame=launches / frames, copies_per_frame=copies / frames,
                kernel_ms_per_frame=kernel_ms, idle_share=1.0 - kernel_ms / frame_ms,
                hand_written_ms_per_frame=dict(sorted(ours.items())))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--out", default="profile.json")
    ap.add_argument("--paths", default=",".join(_paths()))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    scene = upload_scene(cornell_box())
    result = {"card": card, "kind": torch.cuda.get_device_name(0), "paths": {}}
    for name in args.paths.split(","):
        cam, cfg = _paths()[name]
        times = _chain(scene, cam, cfg, args.frames)
        frame_ms = statistics.median(times[1:])
        result["paths"][name] = dict(
            frames_ms=times, frame_ms=frame_ms, passes_ms=_passes(scene, cam, cfg, args.frames),
            device=_device(scene, cam, cfg, frame_ms),
        )
        print(name, json.dumps(result["paths"][name]), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
