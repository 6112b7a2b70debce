"""A run of one cell: set-up, the measured window, the traced frames and
the comparison with the reference.

The window is a user's frame loop (the port's ``app.py`` loop without its
read-back): ``render_frame_restir`` a frame (on an animated scene after
the clip's refit, ``Port.frame``), closed loop, with
``frames_in_flight`` frames queued on the device: before the host submits
frame k it waits for the CUDA event recorded after frame k - in_flight.
Nothing in the window reads a result back to the host.
"""

from __future__ import annotations

import functools
import gzip
import json
import tempfile
import time
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

import torch

from . import check, spec
from .port import Port
from .trace import FRAME, PROBE, STAGE, Trace
from .traffic import Traffic

PORT = "zetaray_tpu_torch"
REFERENCE = "reference.portref"
# NVIDIA's published H100 SXM peaks at 700 W: float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


class _Clock:
    """End-of-frame marks: CUDA events on the card, the host clock on the
    CPU (where every operation has finished when the call returns)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _patch(targets, wrap):
    """Replace each (module, attr) by ``wrap(fn, key)``; returns the undo list."""
    saved = []
    for mod, attr, key in targets:
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrap(fn, key))
    return saved


def _unpatch(saved):
    for mod, attr, fn in reversed(saved):
        setattr(mod, attr, fn)


def reference_port() -> Port:
    """The reference, which flattens the glTF file on one thread: on the
    loader's default four threads ``load_scene`` now and then returns other
    corners or normals for a primitive (about one load in 60 to 80 on a
    host; on one thread, none in 80), so a reference that loaded so could
    differ from the port without a fault in the port."""
    return Port(REFERENCE, load_workers=1)


def stage_targets(port: Port):
    """(module, function, range name) of every pass in the layer files: the
    ``functions`` that the frame function calls (each inside the port's own
    span of its label) and the ``harness_calls`` that the harness's frame
    (``Port.frame``) makes around it, which no span of the port holds."""
    out = []
    for stem, layer in spec.layers().items():
        for mod, attr, label in layer.get("functions", []) + layer.get("harness_calls", []):
            out.append((port.module(mod), attr, f"{STAGE}{stem}:{label}"))
    return out


class _Tracer:
    """The traced frames of a ``--trace 1`` run: ``torch.profiler`` over a
    lead-in frame and ``frames`` counted ones, a range around each frame and
    pass, and each bounded kernel's launches counted for its roofline."""

    def __init__(self, port: Port, frames: int, out_dir: Path, tag: str):
        self.port, self.n, self.out_dir, self.tag = port, frames, out_dir, tag
        self.first = None  # the lead-in frame's number
        self.launches = []  # (kernel tag, counts) of the counted frames
        self.counting = False
        self.result = None  # (Trace, bound seconds, bounded launches) once stopped

    def start(self, k: int):
        self.first = k
        launchers = spec.layers()["kernels"]["launchers"]

        def stage(fn, name):
            @functools.wraps(fn)  # keeps the wrapper's launch counter where its code looks
            def wrapped(*a, **kw):
                with torch.profiler.record_function(name):
                    return fn(*a, **kw)
            return wrapped

        def launcher(fn, kernel):
            bound = spec.bound(kernel)

            @functools.wraps(fn)
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                if self.counting:
                    with torch.profiler.record_function(PROBE):
                        self.launches.append((kernel, bound.counts(a, kw, out)))
                return out
            return wrapped

        self.saved = _patch(stage_targets(self.port), stage)
        self.saved += _patch([(self.port.module(m), a, tag) for tag, (m, a) in launchers.items()],
                             launcher)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def frames(self):
        return list(range(self.first + 1, self.first + 1 + self.n))

    def context(self, k: int):
        if self.first is None or not self.first <= k <= self.first + self.n:
            return nullcontext()
        self.counting = k > self.first
        return torch.profiler.record_function(f"{FRAME}{k}")

    def done(self, k: int) -> bool:
        """Whether frame k is the last traced one."""
        return self.first is not None and k >= self.first + self.n

    def abandon(self):
        """Close the profiler and restore the wrapped functions after a failure."""
        if self.first is not None and self.result is None:
            self.prof.__exit__(None, None, None)
            _unpatch(self.saved)

    def stop(self):
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        _unpatch(self.saved)
        self.counting = False
        self.out_dir.mkdir(parents=True, exist_ok=True)
        raw = self.out_dir / f"{self.tag}.json"
        self.prof.export_chrome_trace(str(raw))
        data = raw.read_bytes()
        raw.unlink()
        with gzip.open(self.out_dir / f"{self.tag}.json.gz", "wb", compresslevel=3) as f:
            f.write(data)
        events = json.loads(data)["traceEvents"]
        del data, self.prof
        trace = Trace(events, self.frames(), spec.layers()["kernels"]["kernels"])
        bound_s = 0.0
        for kernel, counts in self.launches:
            ops, nbytes = spec.bound(kernel).work({k: int(v) for k, v in counts.items()})
            bound_s += max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)
        return trace, bound_s, [k for k, _ in self.launches]


def load_port_scene(cell: dict, gltf: Path, port: Port, device):
    """(scene, RenderConfig) of the cell on ``device`` through ``port``."""
    tr = cell["traffic"]
    cfg = port.render_config(cell["config"]["render"], int(tr["width"]), int(tr["height"]))
    return port.load(gltf, device, cell["config"]["scene"].get("triangles"),
                     cell["config"].get("animation")), cfg


def warm_up(port: Port, scene, cfg, traffic: Traffic, frame, start_frames: int, device):
    """The set-up's frames 0 .. warm_frames - 1, each waited for. Returns
    (the state after them, (outputs, state) of frame start_frames - 1)."""
    state, start = None, None
    for k in range(traffic.warm_frames):
        out, state = frame(scene, traffic, k, cfg, state)
        if k == start_frames - 1:
            start = (out, state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return state, start


def window(port: Port, scene, cfg, traffic: Traffic, frame, state, seconds: float, device,
           tracer: _Tracer | None = None, max_frames: int | None = None, keep: int | None = None):
    """The measured window from frame ``traffic.warm_frames`` on. Returns a
    namespace: frames, window_s (host clock, first submission to the last
    frame's end), intervals_ms (device, end to end; the first from the
    window's start), host_ms (each call's enqueue time), ``last`` and
    ``kept``: (number, input state, outputs, state) of the last frame and
    of frame ``keep`` (None if the window ended before it)."""
    clock = _Clock(device)
    marks, host_ms = [], []
    k = traffic.warm_frames
    prev, out, kept = state, None, None
    start = clock.mark()
    t0 = time.perf_counter()
    while max_frames is None or len(marks) < max_frames:
        if len(marks) >= traffic.in_flight:
            clock.wait(marks[-traffic.in_flight])
        elapsed = time.perf_counter() - t0
        tracing = tracer is not None and tracer.first is not None and tracer.result is None
        if max_frames is None and elapsed >= seconds and not tracing:
            break
        if tracer is not None and tracer.first is None and host_ms:
            est = sum(host_ms) / len(host_ms) / 1e3
            if elapsed >= 0.5 * seconds - 0.5 * (tracer.n + 1) * est:
                tracer.start(k)
        with tracer.context(k) if tracer is not None else nullcontext():
            h = time.perf_counter()
            out, new_state = frame(scene, traffic, k, cfg, state)
            host_ms.append((time.perf_counter() - h) * 1e3)
        marks.append(clock.mark())
        if k == keep:
            kept = (k, state, out, new_state)
        prev, state = state, new_state
        if tracer is not None and tracer.done(k) and tracer.result is None:
            tracer.result = tracer.stop()
        k += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    ms = [clock.ms(start, marks[0])] + [clock.ms(a, b) for a, b in zip(marks, marks[1:])]
    return SimpleNamespace(frames=len(marks), window_s=window_s, intervals_ms=ms, host_ms=host_ms,
                           last=(k - 1, prev, out, state), kept=kept)


def reference_checks(cell: dict, gltf: Path, traffic: Traffic, device, start, frames: dict,
                     control: bool = False, loaded=None) -> dict:
    """The numbers of the checks (``<check>.<number>``): ``start``, the
    port's (outputs, state) of frame start_frames - 1, against the
    reference's chain from nothing; and each of ``frames`` ({check: (frame
    number, input state, outputs, state)}) against the reference's frame
    from the same input state. With ``control`` the reference's rival is
    the reference itself with every pass's float32 outputs rounded to
    bfloat16, in the port's place. ``loaded``: the reference's (scene,
    RenderConfig), when already loaded."""
    ref = reference_port()
    scene, cfg = load_port_scene(cell, gltf, ref, device) if loaded is None else loaded
    n_start = int(cell["check"]["start_frames"])

    def chain(frames, state=None, k0=0):
        for k in range(k0, k0 + frames):
            out, state = ref.frame(scene, traffic, k, cfg, state)
        return out, state

    def rounded(fn):
        saved = _patch(stage_targets(ref), lambda f, _: (
            lambda *a, **kw: check.round_bf16(f(*a, **kw))))
        try:
            return fn()
        finally:
            _unpatch(saved)

    pairs = {"start": (rounded(lambda: chain(n_start)) if control else start, chain(n_start))}
    for tag, (k, state_in, out, state) in frames.items():
        step = lambda: chain(1, ref.state_from(state_in), k)
        pairs[tag] = (rounded(step) if control else (out, state), step())
    return {f"{tag}.{name}": v for tag, (rival, ref_pair) in pairs.items()
            for name, v in check.numbers(*rival, *ref_pair).items()}


def run(cell: dict, seed: int, seconds: float, trace: bool, t0: float, device,
        frame_hook=None) -> dict:
    """One run of ``cell``; returns the result's fields (see ``run.py``)."""
    port = Port(PORT)
    traffic = Traffic(cell["traffic"], cell["config"]["camera"], seed)
    frame = port.frame if frame_hook is None else frame_hook(port.frame)
    n_start = int(cell["check"]["start_frames"])
    with tempfile.TemporaryDirectory(prefix="rtbench_scene_") as tmp:
        scene_cfg = cell["config"]["scene"]
        gltf = spec.scene_generator(scene_cfg["generator"]).write(tmp, scene_cfg)
        scene, cfg = load_port_scene(cell, gltf, port, device)
        state, start = warm_up(port, scene, cfg, traffic, frame, n_start, device)
        setup_s = time.perf_counter() - t0
        tracer = None
        if trace:
            tracer = _Tracer(port, int(cell["profiled_frames"]),
                             spec.BENCH_DIR / "out", f"trace_{cell['name']}_{seed}")
        try:
            win = window(port, scene, cfg, traffic, frame, state, seconds, device, tracer,
                         keep=traffic.sampled_frame())
        except BaseException:
            if tracer is not None:
                tracer.abandon()
            raise
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        checked = {"sampled": win.kept, "last": win.last}
        if win.kept is None:  # a window too short to reach the sampled frame
            checked["sampled"] = win.last
        del scene, state, win.kept, win.last
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        vals = reference_checks(cell, gltf, traffic, device, start, checked)
        reference_s = time.perf_counter() - t_ref
    correct, rows = check.verdict(vals, cell["check"]["limits"])
    run_rec = SimpleNamespace(setup_s=setup_s, window_s=win.window_s, frames=win.frames,
                              intervals_ms=win.intervals_ms, host_ms=win.host_ms,
                              untraced_host_ms=win.host_ms, trace=None, bound_s=None,
                              bound_kernels=[])
    if tracer is not None and tracer.result is not None:
        run_rec.trace, run_rec.bound_s, run_rec.bound_kernels = tracer.result
        i0 = tracer.first - traffic.warm_frames  # the lead-in frame's index in host_ms
        run_rec.untraced_host_ms = win.host_ms[:i0] + win.host_ms[i0 + tracer.n + 1:]
    return dict(correct=correct, rows=rows, values=vals, run=run_rec, memory_peak_bytes=peak,
                reference_s=reference_s)
