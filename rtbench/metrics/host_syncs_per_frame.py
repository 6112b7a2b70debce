"""host_syncs_per_frame: the host syncs a frame of ``render_frame_restir``
makes (a blocking copy, a read-back, an explicit synchronise), counted by
the port's recorder (``zetaray_tpu_torch.utils.stats``) in the frames run
under the profiler, the mean over them. None without the recorder or
profiled frames."""

import sys


def read(run):
    mod = sys.modules.get("zetaray_tpu_torch.utils.stats")
    frames = list(getattr(getattr(mod, "stats", None), "profiled_frames", None) or ())
    if not frames:
        return None
    return sum(fr.syncs for fr in frames) / len(frames)
