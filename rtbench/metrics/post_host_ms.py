"""post_host_ms: the host's time a frame in the port's post passes: the
self time of the ``post:`` spans of ``render_frame_restir`` (host clock,
no synchronise), the mean over the frames of the port's recorder
(``zetaray_tpu_torch.utils.stats``) that ran with no profiler: the last
60 of the window. None without the recorder or with fewer than 20 frames."""

import sys

LAYER = "post:"
MIN_FRAMES = 20


def read(run):
    mod = sys.modules.get("zetaray_tpu_torch.utils.stats")
    frames = list(getattr(getattr(mod, "stats", None), "frames", None) or ())
    if len(frames) < MIN_FRAMES:
        return None
    return sum(sum(ms for name, ms in fr.self_ms.items() if name.startswith(LAYER))
               for fr in frames) / len(frames)
