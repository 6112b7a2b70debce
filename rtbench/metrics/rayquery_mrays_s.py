"""rayquery_mrays_s: the clustered scene's ray queries' rate, millions of
rays a second of their device time: the rays handed to B8 and B9
(``layers/rayquery.json``) in the profiled frames, as the port's recorder
counts them (``zetaray_tpu_torch.utils.stats``: ``FrameRecord.rays``,
from the tensors' shapes, parked rays included), over those kernels'
device time in the same frames. None without the counter (a port before
it), without profiled frames or where no B8/B9 ran."""

import json
import sys
from pathlib import Path

TAGS = json.loads((Path(__file__).resolve().parent.parent / "layers" / "rayquery.json")
                  .read_text())["kernels"]


def read(run):
    tr = run.trace
    mod = sys.modules.get("zetaray_tpu_torch.utils.stats")
    frames = list(getattr(getattr(mod, "stats", None), "profiled_frames", None) or ())
    if tr is None or not tr.frames or len(frames) < len(tr.frames):
        return None
    counted = frames[-len(tr.frames):]  # the ring ends with the counted frames
    if not all(hasattr(fr, "rays") for fr in counted):
        return None
    rays = sum(fr.rays.get(tag, 0) for fr in counted for tag in TAGS) / len(counted)
    us = tr.per_frame_us(lambda op: op["tag"] in TAGS)
    return rays / us if rays > 0 and us > 0 else None
