"""Where a frame's time goes, for the app and the viewer.

The counterparts of the JAX package's ``render/profile.py``:

- ``time_passes(scene, camera, cfg)`` -> {span: ms}: a short chain of
  frames on the scene's device with the span recorder (``utils.stats``)
  synchronising the device at every span boundary, the median self time
  per span (``<layer>:<pass>``; ``frame`` is the host code between passes)
  over all frames but the first;
- ``profiled(fn, *args)`` and ``trace_frame(trace_dir, fn, *args)``: one
  call under ``torch.profiler``, the port's spans (``zr.<span>``) in its
  trace beside the operators and kernels they launch;
- ``launch_counts()``: each hand-written kernel's launches so far.

The benchmark (``BENCHMARK.json``, ``rtbench/``) measures frames with two
in flight and reads the same spans.
"""

from __future__ import annotations

import os
import statistics

import torch

from . import native
from .render import frame as F
from .utils.stats import stats

# the entry point of each kernel (csrc/*.cu) by its tag
LAUNCHERS = {"B1": "zr_gbuffer", "B2": "zr_ris", "B3": "zr_occlusion", "B4": "zr_bounce_trace",
             "B5": "zr_bounce_shade", "B6": "zr_bounce", "B7": "zr_closest",
             "B8": "zr_stream_closest", "B9": "zr_stream_occlusion", "atrous": "zr_atrous",
             "wavefront": "zr_wavefront_vertex"}


def launch_counts() -> dict:
    """{B1..B9, atrous, wavefront: launches so far} as ``native.launch``
    counts them."""
    return {tag: native.launches[entry] for tag, entry in LAUNCHERS.items()}


def time_passes(scene, camera, cfg, seed: int = 0x2468ACE1, reps: int = 10,
                textures=None) -> dict:
    """{span: ms} of ``cfg``'s frame on ``scene.device``: ``reps`` + 1
    chained frames from frame seed ``seed``, each span of the frame
    synchronising a CUDA device where it starts and ends, the median self
    time per span over all frames but the first (which has no temporal
    reuse and no TAA), largest first. The synchronises add their own cost,
    so the sum exceeds the frame's time."""
    dev = torch.device(scene.device)
    stats.sync_device = dev if dev.type == "cuda" else None
    records, state = [], None
    try:
        for k in range(reps + 1):
            if cfg.mode == "pt":
                F.render_frame(scene, camera.with_jitter(k), seed + k, cfg)
            else:
                _, state = F.render_frame_restir(scene, camera.with_jitter(k), seed + k, cfg,
                                                 state, textures=textures)
            records.append(stats.last.self_ms)
    finally:
        stats.sync_device = None
    names = {name for r in records[1:] for name in r}
    rows = {name: statistics.median(r.get(name, 0.0) for r in records[1:]) for name in names}
    return dict(sorted(rows.items(), key=lambda kv: -kv[1]))


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
