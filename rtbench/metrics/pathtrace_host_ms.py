"""pathtrace_host_ms: the host's time a frame in the port's path trace: the
self time of the ``frame:path trace (B8, B9)`` span of
``render_frame_restir`` (host clock, no synchronise), the mean over the
frames of the port's recorder (``zetaray_tpu_torch.utils.stats``) that ran
with no profiler: the last 60 of the window. None without the recorder,
with fewer than 20 frames or where no frame ran the span."""

import sys

SPAN = "frame:path trace (B8, B9)"
MIN_FRAMES = 20


def read(run):
    mod = sys.modules.get("zetaray_tpu_torch.utils.stats")
    frames = list(getattr(getattr(mod, "stats", None), "frames", None) or ())
    if len(frames) < MIN_FRAMES or not any(SPAN in fr.self_ms for fr in frames):
        return None
    return sum(fr.self_ms.get(SPAN, 0.0) for fr in frames) / len(frames)
