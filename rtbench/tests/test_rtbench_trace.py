"""The metric arithmetic on synthetic profiler events: the union of device
intervals, attribution to frames and outermost passes, the idle gaps, the
95th percentile over every interval, and bound over time."""

from types import SimpleNamespace

import pytest
from rtb import spec
from rtb.trace import Trace, union_us

KERNELS = {"ris_kernel": "B2", "stream_closest_kernel": "B8", "stream_any_hit_kernel": "B9"}


def _host(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _kernel(corr, name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _events():
    """A lead-in frame 9 and profiled frames 10, 11: frame 10 launches a
    reuse kernel, B8 inside it and a post kernel; frame 11 launches B2 and
    an overlapping copy; a probe's kernel is left out everywhere."""
    ev = [
        _host("rtbench.frame.9", 0, 100), _host("rtbench.frame.10", 100, 100),
        _host("rtbench.frame.11", 200, 100),
        _host("rtbench.stage.reuse:GI initial samples", 110, 40),
        _host("rtbench.stage.frame:inner", 115, 5),  # nested: the outer stage counts
        _host("rtbench.stage.post:a-trous", 160, 30),
        _host("rtbench.stage.reuse:DI RIS (B2)", 210, 20), _host("rtbench.probe", 232, 3),
        _launch(1, 50), _kernel(1, "lead_kernel", 300, 50),
        _launch(2, 112), _kernel(2, "elementwise_kernel", 400, 10),
        _launch(3, 116), _kernel(3, "void stream_closest_kernel(float*)", 410, 20),
        _launch(4, 165), _kernel(4, "roll_kernel", 440, 30),
        _launch(5, 215), _kernel(5, "(anonymous namespace)::ris_kernel(int)", 480, 10),
        _launch(6, 220), _kernel(6, "Memcpy DtoD", 485, 20, cat="gpu_memcpy"),
        _launch(7, 233), _kernel(7, "probe_sum", 520, 100),
        _launch(8, 400), _kernel(8, "after_kernel", 900, 5),  # outside every frame
    ]
    return ev


def test_union_clips_and_merges():
    assert union_us([(0, 10), (5, 15), (20, 30)], 0, 100) == 25
    assert union_us([(0, 10), (5, 15), (20, 30)], 8, 25) == 7 + 5
    assert union_us([], 0, 10) == 0


def test_trace_attributes_ops_to_frames_and_outermost_passes():
    tr = Trace(_events(), [10, 11], KERNELS)
    by = {op["name"]: op for op in tr.ops}
    assert "probe_sum" not in by and "after_kernel" not in by
    assert by["void stream_closest_kernel(float*)"]["layer"] == "reuse"  # nested in reuse
    assert by["void stream_closest_kernel(float*)"]["tag"] == "B8"
    assert by["roll_kernel"]["layer"] == "post" and by["roll_kernel"]["frame"] == 10
    assert by["(anonymous namespace)::ris_kernel(int)"]["tag"] == "B2"
    assert tr.kernels_per_frame() == 4 / 2  # the copy is no kernel; the lead-in not counted
    # span: the lead-in's last op ends at 350, the last counted op at 505
    assert (tr.span_lo, tr.span_hi) == (350, 505)
    # busy in [350, 505]: 400-430, 440-470, 480-505
    assert tr.busy_us() == 30 + 30 + 25
    assert tr.per_frame_us(lambda op: op["layer"] == "reuse" and op["tag"] != "B8") == (10 + 10) / 2
    gaps = dict(tr.idle_gaps())
    # 350-400, 430-440 and 470-480; the host's ranges had all closed by 300
    assert gaps["no traced range"] == pytest.approx(50e-6 + 10e-6 + 10e-6)
    assert sum(v for _, v in tr.top_ops()) == pytest.approx((10 + 20 + 30 + 10 + 20) * 1e-6)


def _run(**kw):
    base = dict(intervals_ms=[], window_s=0.0, frames=0, setup_s=0.0, untraced_host_ms=[],
                trace=None, bound_s=None, bound_kernels=[])
    return SimpleNamespace(**dict(base, **kw))


def test_frame_metrics():
    iv = [float(x) for x in range(1, 101)]
    run = _run(intervals_ms=iv, window_s=5.0, frames=100)
    assert spec.metric("frame_ms").read(run) == 50.0
    # statistics.quantiles' exclusive method over all 100 intervals
    assert spec.metric("frame_p95_ms").read(run) == pytest.approx(95.95)
    assert spec.metric("frame_p95_ms").read(_run(intervals_ms=iv[:10])) is None


def test_device_metrics_and_roofline():
    tr = Trace(_events(), [10, 11], KERNELS)
    run = _run(trace=tr, bound_s=15e-6, bound_kernels=["B8", "B2"], untraced_host_ms=[2.0, 4.0])
    assert spec.metric("device_idle_pct").read(run) == pytest.approx(100 * (1 - 85 / 155))
    assert spec.metric("launches_per_frame").read(run) == 2.0
    assert spec.metric("rayquery_ms").read(run) == pytest.approx(20e-3 / 2)
    assert spec.metric("reuse_ms").read(run) == pytest.approx(20e-3 / 2)
    assert spec.metric("post_ms").read(run) == pytest.approx(30e-3 / 2)
    assert spec.metric("host_enqueue_ms").read(run) == 3.0
    # 15 us of bound over the B8 and B2 launches' 20 + 10 us
    assert spec.metric("kernels_roofline").read(run) == pytest.approx(50.0)
    # a count that disagrees with the trace leaves the metric out
    assert spec.metric("kernels_roofline").read(
        _run(trace=tr, bound_s=1e-6, bound_kernels=["B8", "B8"])) is None
    assert spec.metric("kernels_roofline").read(_run(trace=tr)) is None
    assert spec.metric("reuse_ms").read(_run()) is None


def test_bounds_count_a_launch():
    import torch

    b8, b9, b2 = spec.bound("B8"), spec.bound("B9"), spec.bound("B2")
    scene = SimpleNamespace(woop=torch.zeros(4, 3 * 8))
    tri = torch.tensor([3, -1, 3, 5], dtype=torch.int32)
    c = {k: int(v) for k, v in b8.counts((scene, torch.zeros(4, 3)), {}, (None, tri)).items()}
    assert c == {"rays": 4, "hits": 3, "slots": 2}
    assert b8.work(c) == (40 * 3, 4 * 8 * 4 + 2 * 12 * 4)
    c = {k: int(v) for k, v in b9.counts((scene, torch.zeros(5, 3)), {},
                                         torch.tensor([1, 0, 1, 1, 0]).bool()).items()}
    assert b9.work(c) == (40 * 3, 5 * 7 * 4)
    gbuf = torch.zeros(40, 6)
    gbuf[15, :4] = 1.0
    c = {k: int(v) for k, v in b2.counts((gbuf, torch.zeros(7, 16, 32)), {}, None).items()}
    assert b2.work(c) == (32 * (4 * 32 + 2), 6 * 26 * 4 + 7 * 11 * 32 * 4)
