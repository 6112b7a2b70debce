"""Frame stats and kernel timing (App::AddFrameStat / GpuTimer analogs).

The reference keeps per-frame stat groups, a 60-frame frame-time history,
and per-pass GPU timestamps shown in the UI (Win32App.cpp:609-646,
GpuTimer.h:28-48). Here, as in the JAX package's ``utils/stats.py``:

  - ``FrameStats``: named per-frame counters and a ring of frame times;
  - ``KernelTimer``: named timing spans around groups of launches. A span
    whose work runs on a CUDA device is timed there, between two
    ``torch.cuda.Event``s recorded on the device's current stream; on the
    CPU it takes the host clock, after an optional ``sync``.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from contextlib import contextmanager

import torch


class FrameStats:
    HISTORY = 60  # frames, like the reference's frame-time graph

    def __init__(self):
        self._curr: dict[str, dict[str, float]] = defaultdict(dict)
        self._history: deque = deque(maxlen=self.HISTORY)
        self._frame_times: deque = deque(maxlen=self.HISTORY)
        self._frame_start = None
        self.frame_index = 0

    def begin_frame(self):
        self._frame_start = time.perf_counter()
        self._curr = defaultdict(dict)

    def add(self, group: str, name: str, value) -> None:
        """App::AddFrameStat equivalent."""
        self._curr[group][name] = float(value)

    def end_frame(self):
        dt = 0.0
        if self._frame_start is not None:
            dt = time.perf_counter() - self._frame_start
        self._frame_times.append(dt)
        self._history.append({g: dict(v) for g, v in self._curr.items()})
        self.frame_index += 1
        return dt

    @property
    def fps(self) -> float:
        if not self._frame_times:
            return 0.0
        avg = sum(self._frame_times) / len(self._frame_times)
        return 1.0 / avg if avg > 0 else 0.0

    def frame_time_ms(self) -> float:
        return (self._frame_times[-1] * 1000.0) if self._frame_times else 0.0

    def report(self) -> str:
        lines = [
            f"frame {self.frame_index} | {self.frame_time_ms():.2f} ms | "
            f"{self.fps:.1f} fps (avg over {len(self._frame_times)})"
        ]
        last = self._history[-1] if self._history else {}
        for group in sorted(last):
            for name, v in sorted(last[group].items()):
                lines.append(f"  {group}/{name}: {v:g}")
        return "\n".join(lines)


class KernelTimer:
    """Named timing spans (GpuTimer::BeginQuery/EndQuery shape)."""

    def __init__(self):
        self.spans: dict[str, float] = {}

    @contextmanager
    def span(self, name: str, sync=None, device=None):
        """Time a block, in ms. ``device``: where the block's tensors are;
        on a CUDA device the span is the device time between two events
        recorded on its current stream before and after the block (the host
        waits for the second). Elsewhere the host clock times the block,
        after ``sync()`` where one is given (a function that waits for the
        block's results)."""
        if device is not None and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            yield
            end.record(stream)
            end.synchronize()
            self.spans[name] = start.elapsed_time(end)
            return
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        self.spans[name] = (time.perf_counter() - t0) * 1000.0

    def report(self) -> str:
        return "\n".join(f"  {k}: {v:.2f} ms" for k, v in sorted(self.spans.items()))


stats = FrameStats()
