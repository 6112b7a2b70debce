"""Frame stats and the host-time span recorder (App::AddFrameStat / GpuTimer
analogs).

The reference keeps per-frame stat groups, a 60-frame frame-time history,
and per-pass GPU timestamps shown in the UI (Win32App.cpp:609-646,
GpuTimer.h:28-48). Here ``FrameStats`` keeps the stat groups and frame
times of the app's ``begin_frame``/``end_frame``, and records spans:

  - ``span(name)`` times a block on the host clock (``perf_counter_ns``,
    no synchronise) and keeps its total and self time (self time leaves
    out the spans nested in it). Names are ``<layer>:<pass>``, the layer
    one of ``frame``, ``reuse``, ``post``, ``setup``. While
    ``torch.profiler`` records, a span also opens
    ``record_function("zr." + name)``, so the spans lie in the profiler's
    trace beside the kernels they launch; otherwise it opens none.
  - ``frame()`` is the root span ``frame`` of one frame call: it commits a
    ``FrameRecord`` of host ms per span, to the ring ``frames`` (the last
    ``HISTORY`` frames run with no profiler) or ``profiled_frames`` (the
    last ``PROFILED_HISTORY`` run under one).
  - In a profiled frame every host sync is counted against the innermost
    open span and the ``file:line`` that made it (``_site``): the frame sets
    ``torch.cuda.set_sync_debug_mode("warn")`` and takes PyTorch's
    synchronising-operation warnings out of the warning stream (any other
    warning passes on); ``synchronize`` counts an explicit one.
  - A ``setup:`` span keeps the seconds of its last call in ``setup``.
  - ``count_rays(kernel, n)`` adds the ``n`` rays a ray query hands to a
    kernel (B3, B7, B8, B9; ``accel.intersect`` counts each query once,
    where it dispatches it) to the frame's ``FrameRecord.rays``. The count
    is read from the tensors' shapes on the host: no device read, no sync.

``sync_device`` (set by ``profile.time_passes``) synchronises that device
at every span boundary, so that a span's time holds its device work.
"""

from __future__ import annotations

import functools
import os
import sys
import time
import warnings
from collections import defaultdict, deque
from dataclasses import dataclass, field

import torch

SYNC_WARNING = "called a synchronizing CUDA operation"
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = (os.path.dirname(torch.__file__), __file__, warnings.__file__)


@dataclass
class FrameRecord:
    """One frame call: host ms per span name (``ms`` total, ``self_ms``
    without nested spans; a span entered twice sums), the rays handed to
    the ray query kernels by kernel (``rays``: {"B8": n, ...}), and in a
    profiled frame the host syncs, by (span, ``file:line``) in
    ``sync_sites``."""

    ms: dict = field(default_factory=dict)
    self_ms: dict = field(default_factory=dict)
    syncs: int = 0
    sync_sites: dict = field(default_factory=dict)
    profiled: bool = False
    rays: dict = field(default_factory=dict)


def _site(filename: str, lineno: int) -> str:
    """``file:line`` of the code that made a sync: ``filename:lineno``, or
    where that lies in torch's own Python, its nearest caller outside torch.
    A file of the port is named from the package's root, others from the
    package's parent (the checkout's root)."""
    if filename.startswith(_SKIP):
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename.startswith(_SKIP):
            f = f.f_back
        if f is not None:
            filename, lineno = f.f_code.co_filename, f.f_lineno
    root = _PKG if filename.startswith(_PKG + os.sep) else os.path.dirname(_PKG)
    return f"{os.path.relpath(filename, root)}:{lineno}"


class _Span:
    __slots__ = ("rec", "name", "t0", "child", "rf")

    def __init__(self, rec: "FrameStats", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function("zr." + self.name)
            self.rf.__enter__()
        if rec.sync_device is not None:
            torch.cuda.synchronize(rec.sync_device)
        self.child = 0
        rec._open.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec.sync_device is not None:
            torch.cuda.synchronize(rec.sync_device)
        ns = time.perf_counter_ns() - self.t0
        rec._open.pop()
        if rec._open:
            rec._open[-1].child += ns
        fr = rec._frame
        if fr is not None:
            fr.ms[self.name] = fr.ms.get(self.name, 0) + ns
            fr.self_ms[self.name] = fr.self_ms.get(self.name, 0) + ns - self.child
        if self.name.startswith("setup:"):
            rec.setup[self.name] = ns * 1e-9
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _Frame:
    """The root span ``frame``; commits the frame's record on a clean exit."""

    __slots__ = ("rec", "span", "root", "watch")

    def __init__(self, rec: "FrameStats"):
        self.rec, self.span = rec, _Span(rec, "frame")

    def __enter__(self):
        rec = self.rec
        self.root = rec._frame is None  # a frame inside a frame is a span of the outer one
        self.watch = None
        if self.root:
            rec._frame = FrameRecord(profiled=torch.autograd._profiler_enabled())
            if rec._frame.profiled:
                self.watch = rec._watch_syncs()
        self.span.__enter__()
        return self

    def __exit__(self, exc_type, *exc):
        rec = self.rec
        try:
            self.span.__exit__(exc_type, *exc)
        finally:
            if self.root:
                if self.watch is not None:
                    rec._unwatch_syncs(self.watch)
                fr, rec._frame = rec._frame, None
                if exc_type is None:
                    rec._commit(fr)
        return False


class FrameStats:
    HISTORY = 60  # frames, like the reference's frame-time graph
    PROFILED_HISTORY = 8

    def __init__(self):
        self._curr: dict[str, dict[str, float]] = defaultdict(dict)
        self._history: deque = deque(maxlen=self.HISTORY)
        self._frame_times: deque = deque(maxlen=self.HISTORY)
        self._frame_start = None
        self.frame_index = 0
        self.frames: deque = deque(maxlen=self.HISTORY)
        self.profiled_frames: deque = deque(maxlen=self.PROFILED_HISTORY)
        self.last: FrameRecord | None = None
        self.setup: dict[str, float] = {}
        self.sync_device = None
        self._open: list[_Span] = []
        self._frame: FrameRecord | None = None

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
        if self.last is not None:
            for name, ms in sorted(self.last.self_ms.items(), key=lambda kv: -kv[1]):
                lines.append(f"  host/{name}: {ms:.3f} ms")
            if self.last.profiled:
                lines.append(f"  host/syncs: {self.last.syncs}")
        return "\n".join(lines)

    # -- spans -------------------------------------------------------------

    def span(self, name: str) -> _Span:
        """A context manager that times its block as span ``name``."""
        return _Span(self, name)

    def frame(self) -> _Frame:
        """A context manager around one frame call: the root span ``frame``,
        which commits the frame's ``FrameRecord``."""
        return _Frame(self)

    def count_rays(self, kernel: str, n: int) -> None:
        """Count ``n`` rays handed to the ray query kernel ``kernel`` in the
        open frame (none open: nothing)."""
        fr = self._frame
        if fr is not None:
            fr.rays[kernel] = fr.rays.get(kernel, 0) + int(n)

    def synchronize(self, device=None) -> None:
        """``torch.cuda.synchronize(device)``, counted as a host sync in a
        profiled frame."""
        if self._frame is not None and self._frame.profiled:
            f = sys._getframe(1)
            self._count_sync(_site(f.f_code.co_filename, f.f_lineno))
        torch.cuda.synchronize(device)

    def _count_sync(self, site: str) -> None:
        fr = self._frame
        key = (self._open[-1].name if self._open else "frame", site)
        fr.syncs += 1
        fr.sync_sites[key] = fr.sync_sites.get(key, 0) + 1

    def _watch_syncs(self):
        """Start counting the syncs of a profiled frame; returns what
        ``_unwatch_syncs`` restores."""
        ctx = warnings.catch_warnings()
        ctx.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        passed_on = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                self._count_sync(_site(filename, lineno))
            else:
                passed_on(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        mode = None
        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
            # setting the mode warns that it is a prototype: the frame's own act
            warnings.filterwarnings("ignore", message="Synchronization debug mode")
            torch.cuda.set_sync_debug_mode("warn")
        return ctx, mode

    def _unwatch_syncs(self, watch) -> None:
        ctx, mode = watch
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        ctx.__exit__(None, None, None)

    def _commit(self, fr: FrameRecord) -> None:
        fr.ms = {k: v * 1e-6 for k, v in fr.ms.items()}
        fr.self_ms = {k: v * 1e-6 for k, v in fr.self_ms.items()}
        (self.profiled_frames if fr.profiled else self.frames).append(fr)
        self.last = fr


stats = FrameStats()


def framed(fn):
    """``fn`` with each call one frame of ``stats`` (``FrameStats.frame``)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with stats.frame():
            return fn(*args, **kwargs)
    return wrapped


def spanned(name: str):
    """Decorator: each call of the function is the span ``name`` of ``stats``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with stats.span(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco
