"""Reduce a ``torch.profiler`` Chrome trace of the profiled frames.

The harness marks the host side with ``record_function`` ranges:
``rtbench.frame.<k>`` around each frame's call, ``rtbench.stage.<layer>:<pass>``
around each pass of a layer file, and ``rtbench.probe`` around the kernel
bounds' own reductions, which are left out of every number. A device
operation (kernel, memcpy, memset) belongs to the frame and the outermost
stage whose range holds the host call that launched it (matched by the
trace's correlation id).

All times here are microseconds, as in the trace.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

FRAME = "rtbench.frame."
STAGE = "rtbench.stage."
PROBE = "rtbench.probe"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_tag(name: str, table: dict):
    """The tag (B1..B9) of a hand-written kernel's event name, else None.
    Whole names: B7's closest_kernel ends B8's stream_closest_kernel."""
    for kernel, tag in table.items():
        if re.search(rf"(?<![A-Za-z_]){kernel}", name):
            return tag
    return None


class _Spans:
    """Non-overlapping host ranges [(start, end, name)], sorted, for lookups."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.spans[i][0] <= t <= self.spans[i][1]:
            return self.spans[i][2]
        return None


def _outermost(spans):
    out, end = [], float("-inf")
    for s in sorted(spans, key=lambda x: (x[0], -x[1])):
        if s[0] >= end:
            out.append(s)
            end = s[1]
    return out


def union_us(intervals, lo, hi) -> float:
    """Length of the union of [start, end] intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Trace:
    """The device operations of the profiled frames and the host ranges
    around them. ``frames``: the frame numbers that count (the lead-in
    frame before them is traced only to mark where the span starts)."""

    def __init__(self, events: list, frames: list, kernels: dict):
        self.frames = list(frames)
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        span = lambda e: (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
        frame_spans = [span(e) for e in host if e["name"].startswith(FRAME)]
        self.stage_spans = [span(e) for e in host if e["name"].startswith(STAGE)]
        probe_spans = [span(e) for e in host if e["name"] == PROBE]
        self._frames = _Spans(frame_spans)
        self._stages = _Spans(_outermost(self.stage_spans))
        self._probes = _Spans(probe_spans)
        self.host_spans = frame_spans + self.stage_spans
        launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e
                  and "correlation" in e["args"]}
        self.ops = []  # device operations launched in a traced frame, probes left out
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            t_launch = launch.get(e.get("args", {}).get("correlation"))
            if t_launch is None or self._probes.at(t_launch):
                continue
            fr = self._frames.at(t_launch)
            if fr is None:
                continue
            stage = self._stages.at(t_launch)
            name = e["name"]
            self.ops.append(dict(
                name=name, cat=e["cat"], ts=float(e["ts"]), dur=float(e.get("dur", 0.0)),
                frame=int(fr[len(FRAME):]), stage=stage,
                layer=stage[len(STAGE):].split(":", 1)[0] if stage else None,
                tag=kernel_tag(name, kernels) if e["cat"] == "kernel" else None))
        counted = set(self.frames)
        self.counted = [op for op in self.ops if op["frame"] in counted]
        lead = [op for op in self.ops if op["frame"] < min(counted)]
        ends = [op["ts"] + op["dur"] for op in self.counted]
        # the span: from the lead-in frame's last device operation to the
        # last one of the profiled frames
        self.span_lo = max((op["ts"] + op["dur"] for op in lead), default=min(
            (op["ts"] for op in self.counted), default=0.0))
        self.span_hi = max(ends, default=self.span_lo)

    @property
    def window_us(self) -> float:
        return self.span_hi - self.span_lo

    def busy_us(self) -> float:
        """Time in the span during which some device operation ran (any
        frame's: frames in flight overlap)."""
        return union_us([(op["ts"], op["ts"] + op["dur"]) for op in self.ops],
                        self.span_lo, self.span_hi)

    def per_frame_us(self, pick) -> float:
        """Device time per profiled frame of the kernels ``pick(op)`` keeps."""
        return sum(op["dur"] for op in self.counted
                   if op["cat"] == "kernel" and pick(op)) / len(self.frames)

    def kernels_per_frame(self) -> float:
        return sum(op["cat"] == "kernel" for op in self.counted) / len(self.frames)

    def top_ops(self, n: int = 10):
        """[[kernel name, seconds]] of the longest device operations by name."""
        by = defaultdict(float)
        for op in self.counted:
            by[op["name"]] += op["dur"]
        return [[k, v * 1e-6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """[[host range, seconds]]: the device's idle time in the span,
        summed by the innermost host range open when each gap began."""
        intervals = sorted((op["ts"], op["ts"] + op["dur"]) for op in self.ops)
        gaps, cur = [], self.span_lo
        for s, e in intervals:
            if e <= self.span_lo or s >= self.span_hi:
                continue
            if s > cur:
                gaps.append((cur, min(s, self.span_hi)))
            cur = max(cur, e)
        if cur < self.span_hi:
            gaps.append((cur, self.span_hi))
        by = defaultdict(float)
        spans = sorted(self.host_spans)
        active, i = [], 0
        for g0, g1 in gaps:  # a sweep: the ranges open at each gap's start
            while i < len(spans) and spans[i][0] <= g0:
                active.append(spans[i])
                i += 1
            active = [s for s in active if s[1] >= g0]
            inner = min(active, key=lambda s: s[1] - s[0], default=None)
            name = "no traced range" if inner is None else inner[2]
            if name.startswith(FRAME):
                name = "frame (between passes)"
            by[name] += g1 - g0
        return [[k, v * 1e-6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
