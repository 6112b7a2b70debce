"""The port's span recorder and host-sync counter (``utils.stats``), the
spans of the frame functions and of the scene's set-up, and the
benchmark's readers of them (``rtbench/metrics``).

Nothing here imports JAX: the card-only test runs with

    python -m pytest tests/test_torch_trace.py -m cuda --noconftest -q
"""

import importlib.util
import json
import sys
import time
import warnings
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from zetaray_tpu_torch.ops import post
from zetaray_tpu_torch.ops.pathtracer import PTConfig, trace_reference
from zetaray_tpu_torch.ops.upscale import UpscaleConfig
from zetaray_tpu_torch.render import frame as TF
from zetaray_tpu_torch.scene.camera import Camera
from zetaray_tpu_torch.scene.procedural import (
    CAMERA_EYE, CAMERA_TARGET, CAMERA_VFOV, animated_box, cornell_box,
)
from zetaray_tpu_torch.scene.scene import load_scene, upload_scene
from zetaray_tpu_torch.scene.subdivide import subdivide_scene
from zetaray_tpu_torch.utils import stats as TST
from zetaray_tpu_torch.utils.stats import SYNC_WARNING, FrameRecord, FrameStats

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "rtbench"
CPU = [torch.profiler.ProfilerActivity.CPU]
# operators that make no data: views and metadata
VIEWS = {"view", "reshape", "permute", "select", "slice", "expand", "unsqueeze", "squeeze",
         "as_strided", "t", "transpose", "detach", "alias"}
MODES = {
    "restir_gi": dict(width=16, height=8),
    # rendered at 16x8, upscaled to 32x16 and sharpened
    "restir_pt": dict(width=32, height=16, render_scale=0.5,
                      upscale_cfg=UpscaleConfig(rcas_sharpness=0.8)),
    "restir_di": dict(width=16, height=8),
}


@pytest.fixture(scope="module")
def scene():
    return upload_scene(cornell_box(), device="cpu")


def _cfg(mode):
    return TF.RenderConfig(mode=mode, pt=PTConfig(max_bounces=2), denoise=True, taa=True,
                           firefly_factor=4.0, **MODES[mode])


def _frames(scene, cfg, n, state=None, k0=0):
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV,
                         aspect=cfg.width / cfg.height)
    for k in range(k0, k0 + n):
        _, state = TF.render_frame_restir(scene, cam.with_jitter(k), 0x5EED + k, cfg, state)
    return state


def test_span_nesting_and_self_time():
    rec = FrameStats()
    with rec.frame():
        with rec.span("post:outer"):
            time.sleep(0.002)
            with rec.span("post:inner"):
                time.sleep(0.004)
        for _ in range(2):  # a span entered twice sums
            with rec.span("reuse:twice"):
                time.sleep(0.001)
    fr = rec.last
    assert list(rec.frames) == [fr] and not fr.profiled and fr.syncs == 0
    assert fr.ms["post:inner"] >= 4.0 and fr.self_ms["post:inner"] == fr.ms["post:inner"]
    assert fr.self_ms["post:outer"] == pytest.approx(fr.ms["post:outer"] - fr.ms["post:inner"])
    assert fr.self_ms["post:outer"] >= 2.0 and fr.ms["reuse:twice"] >= 2.0
    assert fr.self_ms["frame"] == pytest.approx(
        fr.ms["frame"] - fr.ms["post:outer"] - fr.ms["reuse:twice"], abs=1e-6)
    assert rec._open == [] and rec._frame is None
    with pytest.raises(ValueError), rec.frame():  # a frame that raises commits nothing
        with rec.span("post:outer"):
            raise ValueError("no frame")
    assert len(rec.frames) == 1 and rec._open == [] and rec._frame is None


def test_one_record_per_frame_call(scene):
    """Both frame functions commit a record a call, with or without the
    app's begin_frame/end_frame, whose report then shows each span."""
    cfg = _cfg("restir_gi")
    n0 = len(TST.stats.frames)
    state = _frames(scene, cfg, 2)
    assert len(TST.stats.frames) == min(n0 + 2, FrameStats.HISTORY)
    assert "reuse:GI temporal reuse" in TST.stats.last.self_ms
    TST.stats.begin_frame()
    _frames(scene, cfg, 1, state, 2)
    TST.stats.end_frame()
    report = TST.stats.report()
    assert "  host/post:a-trous: " in report and "  host/frame: " in report
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=2.0)
    TF.render_frame(scene, cam, 3, TF.RenderConfig(width=16, height=8, mode="pt"))
    assert set(TST.stats.last.self_ms) == {
        "frame", "frame:camera rays", "frame:path trace (B8, B9)", TF.POST_CHAIN}


def test_rings_and_setup_spans():
    rec = FrameStats()
    for _ in range(FrameStats.HISTORY + 5):
        with rec.frame():
            pass
    with torch.profiler.profile(activities=CPU):
        for _ in range(FrameStats.PROFILED_HISTORY + 3):
            with rec.frame():
                pass
    assert len(rec.frames) == FrameStats.HISTORY
    assert len(rec.profiled_frames) == FrameStats.PROFILED_HISTORY
    assert all(fr.profiled for fr in rec.profiled_frames)
    assert not any(fr.profiled for fr in rec.frames)
    for s in (0.004, 0.001):  # a one-shot span keeps its last call
        with rec.span("setup:x"):
            time.sleep(s)
    assert 0.001 <= rec.setup["setup:x"] < 0.004


def test_scene_setup_spans(tmp_path):
    cpu = load_scene(animated_box(tmp_path / "box.gltf"))
    upload_scene(cpu, device="cpu")
    assert set(TST.stats.setup) >= {"setup:load_scene", "setup:upload_scene"}
    assert all(s > 0.0 for s in TST.stats.setup.values())


def test_no_profiler_no_ranges_and_no_sync_mode(scene, monkeypatch):
    """With no profiler running a frame opens no record_function and sets
    no sync debug mode; under the CPU profiler its ``zr.`` ranges appear."""
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda mode: opened.append(f"sync mode {mode}"))
    cfg = _cfg("restir_gi")
    state = _frames(scene, cfg, 2)
    assert opened == []
    monkeypatch.undo()
    with torch.profiler.profile(activities=CPU) as prof:
        _frames(scene, cfg, 1, state, 2)
    names = {e.name for e in prof.events()}
    assert {"zr.frame", "zr.reuse:GI initial samples (B8, B9)", "zr.post:a-trous"} <= names
    assert TST.stats.last.profiled and TST.stats.profiled_frames[-1] is TST.stats.last


def _layer_entries():
    """[(module, function, span name)] of every pass in ``rtbench/layers``."""
    out = []
    for path in sorted((BENCH / "layers").glob("*.json")):
        for mod, attr, label in json.loads(path.read_text()).get("functions", []):
            out.append((f"zetaray_tpu_torch.{mod}", attr, f"{path.stem}:{label}"))
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_a_span_for_each_layer_entry(scene, mode, monkeypatch):
    """Each layer file's function that the mode calls as a pass (not from
    inside another listed function) runs inside the span named after its
    entry's label."""
    calls, depth = [], [0]
    for mod, attr, span in _layer_entries():
        fn = getattr(sys.modules[mod], attr)

        def wrapped(*a, _fn=fn, _span=span, **kw):
            if not depth[0]:
                calls.append((_span, [s.name for s in TST.stats._open]))
            depth[0] += 1
            try:
                return _fn(*a, **kw)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(sys.modules[mod], attr, wrapped)
    _frames(scene, _cfg(mode), 2)
    assert len({span for span, _ in calls}) >= 10
    for span, open_spans in calls:
        assert span in open_spans, (span, open_spans)
    if mode == "restir_pt":
        assert "post:RCAS" in TST.stats.last.self_ms


@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_operator_in_a_pass_span(scene, mode):
    """Under the CPU profiler every operator of the frame that makes data
    runs inside a pass's span, not in the frame's own code."""
    cfg = _cfg(mode)
    state = _frames(scene, cfg, 1)
    with torch.profiler.profile(activities=CPU) as prof:
        _frames(scene, cfg, 1, state, 1)
    in_pass, outside = 0, []
    for e in prof.events():
        if not e.name.startswith("aten::") or e.name[6:] in VIEWS:
            continue
        spans, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith("zr."):
                spans.append(p.name)
            p = p.cpu_parent
        if spans == ["zr.frame"]:
            outside.append(e.name)
        elif spans:
            in_pass += 1
    assert in_pass > 100 and outside == []


def test_sync_warnings_counted_in_profiled_frames():
    """In a profiled frame a synchronising-operation warning is counted
    against the innermost span and its file:line, and kept from the
    caller; any other warning reaches the caller. Outside one it passes."""
    rec = FrameStats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.profiler.profile(activities=CPU):
            with rec.frame():
                with rec.span("post:x"):
                    line = sys._getframe().f_lineno + 1
                    warnings.warn(f"{SYNC_WARNING} (Triggered internally at x.cpp:1.)")
                warnings.warn("not a sync")
        with rec.frame():
            warnings.warn(SYNC_WARNING)
    fr = rec.profiled_frames[-1]
    assert fr.syncs == 1 and len(fr.sync_sites) == 1
    (span, site), = fr.sync_sites
    assert span == "post:x" and site == f"tests/test_torch_trace.py:{line}"
    assert [str(w.message) for w in caught] == ["not a sync", SYNC_WARNING]
    assert rec.last.syncs == 0


@pytest.fixture(scope="module")
def clustered():
    """The box split to 546 triangles, clustered (128 slots a cluster)."""
    return upload_scene(subdivide_scene(cornell_box(), 500), device="cpu", cluster_size=128)


@pytest.mark.parametrize("kind", ["dense", "clustered"])
def test_ray_counter_counts_each_query_once(scene, clustered, kind):
    """A frame's record counts the rays each ray query hands its kernel:
    B8 and B9 on a clustered scene, B7 and B3 on a dense one. A 4-bounce
    wavefront trace hands its n rays to 5 closest-hit and 4 any-hit
    queries. The ``restir_di`` frame's are the G-buffer (B8; on a dense
    scene B1, no query), DI visibility and shade, and on a clustered scene
    its path trace's 5 closest hits and 3 NEE segments (from bounce 1; on a
    dense scene B6 traces the path)."""
    sc = clustered if kind == "clustered" else scene
    closest, any_hit = ("B8", "B9") if kind == "clustered" else ("B7", "B3")
    w, h = 16, 8
    n = w * h
    cam = Camera.look_at(CAMERA_EYE, CAMERA_TARGET, vfov_deg=CAMERA_VFOV, aspect=w / h)
    o, d = cam.generate_rays(w, h, device="cpu")
    with TST.stats.frame():
        trace_reference(sc, o, d, 5, PTConfig(max_bounces=4))
    assert TST.stats.last.rays == {closest: 5 * n, any_hit: 4 * n}
    trace_reference(sc, o, d, 5, PTConfig(max_bounces=1))  # outside a frame: not counted
    cfg = TF.RenderConfig(width=w, height=h, mode="restir_di", pt=PTConfig(max_bounces=4))
    _frames(sc, cfg, 2)
    want = {"B8": 6 * n, "B9": 5 * n} if kind == "clustered" else {"B3": 2 * n}
    assert TST.stats.last.rays == want


def test_ray_counter_adds_no_operation_or_sync(clustered, monkeypatch):
    """The counter takes its counts from shapes on the host: a profiled
    frame runs the same operators and counts the same syncs with it as
    without it, and it is handed Python ints."""
    cfg = TF.RenderConfig(width=16, height=8, mode="restir_di", pt=PTConfig(max_bounces=4))
    state = _frames(clustered, cfg, 1)
    handed = []
    count = FrameStats.count_rays

    def spy(self, kernel, n):
        handed.append(type(n))
        count(self, kernel, n)

    def profiled():
        with torch.profiler.profile(activities=CPU) as prof:
            _frames(clustered, cfg, 1, state, 1)
        return Counter(e.name for e in prof.events() if e.name.startswith("aten::")), TST.stats.last

    monkeypatch.setattr(FrameStats, "count_rays", spy)
    ops_on, fr_on = profiled()
    monkeypatch.setattr(FrameStats, "count_rays", lambda self, kernel, n: None)
    ops_off, fr_off = profiled()
    assert fr_on.profiled and fr_on.rays and not fr_off.rays
    assert set(handed) == {int} and len(handed) == 11
    assert ops_on == ops_off and fr_on.syncs == fr_off.syncs


def _reader(name):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _filled(frames=25, profiled=(10, 12)):
    rec = FrameStats()
    for _ in range(frames):
        rec.frames.append(FrameRecord(self_ms={"frame": 9.0, "reuse:a": 1.0, "reuse:b": 2.0,
                                               "post:x": 0.5, "frame:y": 4.0,
                                               "frame:path trace (B8, B9)": 3.5}))
    for n in profiled:
        rec.profiled_frames.append(FrameRecord(syncs=n, profiled=True))
    rec.setup.update({"setup:load_scene": 1.5, "setup:upload_scene": 2.5})
    return rec


READINGS = {"reuse_host_ms": 3.0, "post_host_ms": 0.5, "host_syncs_per_frame": 11.0,
            "scene_load_s": 1.5, "scene_upload_s": 2.5, "pathtrace_host_ms": 3.5}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_readers(name, monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(TST, "stats", _filled())
    assert read(None) == pytest.approx(READINGS[name])
    # too few frames, none profiled, no set-up
    monkeypatch.setattr(TST, "stats", _filled(frames=19, profiled=()))
    TST.stats.setup.clear()
    assert read(None) is None
    # a recorder without the rings (the port before them), or no port at all
    monkeypatch.setattr(TST, "stats", object())
    assert read(None) is None
    monkeypatch.delitem(sys.modules, "zetaray_tpu_torch.utils.stats")
    assert read(None) is None


class _FakeTrace:
    """The profiled frames' device operations as ``rtb.trace.Trace`` hands
    them to the readers."""

    def __init__(self, ops, frames):
        self.counted, self.frames = ops, frames

    def per_frame_us(self, pick):
        return sum(op["dur"] for op in self.counted
                   if op["cat"] == "kernel" and pick(op)) / len(self.frames)


def _op(stage, dur, tag=None):
    return {"cat": "kernel", "stage": f"rtbench.stage.{stage}", "dur": dur, "tag": tag}


def test_trace_readers(monkeypatch):
    """pathtrace_ms (the path trace's kernels, B8/B9 left out), lvg_ms (the
    grid's build and candidates) and rayquery_mrays_s (the counted frames'
    B8/B9 rays over their device time): each reads None where its code did
    not run or its counter is missing."""
    pt, grid = "frame:path trace (B8, B9)", "frame:light voxel grid build"
    cand = "reuse:DI grid candidates"
    ops = [_op(pt, 300.0), _op(pt, 500.0, "B8"), _op(pt, 100.0, "B9"), _op(grid, 40.0),
           _op(cand, 20.0), _op("reuse:DI RIS (B2)", 70.0, "B2"),
           _op("frame:G-buffer (B8)", 200.0, "B8")]
    run = SimpleNamespace(trace=_FakeTrace(ops, [7, 8]))
    assert _reader("pathtrace_ms")(run) == pytest.approx(0.15)
    assert _reader("lvg_ms")(run) == pytest.approx(0.03)
    rec = FrameStats()
    rec.profiled_frames.append(FrameRecord(profiled=True, rays={"B8": 1}))  # the lead-in
    for _ in range(2):
        rec.profiled_frames.append(FrameRecord(profiled=True, rays={"B8": 400, "B9": 200,
                                                                     "B3": 99}))
    monkeypatch.setattr(TST, "stats", rec)
    rate = _reader("rayquery_mrays_s")
    assert rate(run) == pytest.approx(600 / 400.0)  # rays a microsecond: Mrays/s
    none = SimpleNamespace(trace=_FakeTrace([_op("reuse:DI shade (B9)", 5.0, "B9")], [7, 8]))
    assert _reader("pathtrace_ms")(none) is None and _reader("lvg_ms")(none) is None
    assert _reader("pathtrace_ms")(SimpleNamespace(trace=None)) is None
    del rec.profiled_frames[-1].rays  # a recorder without the counter
    assert rate(run) is None
    monkeypatch.setattr(TST, "stats", FrameStats())
    assert rate(run) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sync_counter_on_the_card(cuda):
    rec = FrameStats()
    x = torch.rand(1000, device=cuda)
    hdr = torch.rand(3, 8, 16, device=cuda)
    mode = torch.cuda.get_sync_debug_mode()
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.profiler.profile(activities=acts):
            with rec.frame():
                with rec.span("frame:item"):
                    x.sum().item()
                with rec.span("frame:upload"):
                    torch.tensor(1.0, device=cuda)
                with rec.span("post:exposure"):
                    post.histogram_exposure_p(hdr)
                with rec.span("frame:synchronize"):
                    line = sys._getframe().f_lineno + 1
                    rec.synchronize(cuda)
                warnings.warn("not a sync")
    fr = rec.profiled_frames[-1]
    spans = {span for span, _ in fr.sync_sites}
    assert {"frame:item", "frame:upload", "post:exposure", "frame:synchronize"} <= spans
    assert ("post:exposure", "ops/post.py:60") in fr.sync_sites
    assert ("frame:synchronize", f"tests/test_torch_trace.py:{line}") in fr.sync_sites
    said = [str(w.message) for w in caught]  # the profiler may add its own
    assert "not a sync" in said and not any("ynchroniz" in m for m in said), said
    assert torch.cuda.get_sync_debug_mode() == mode
    with rec.frame():  # no profiler: nothing counted, no mode set
        x.sum().item()
    assert rec.last.syncs == 0 and not rec.last.profiled
