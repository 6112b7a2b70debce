"""rayquery_ms: device time per profiled frame of the clustered scene's ray
query kernels B8 and B9 (``layers/rayquery.json``), wherever launched."""

import json
from pathlib import Path

TAGS = json.loads((Path(__file__).resolve().parent.parent / "layers" / "rayquery.json")
                  .read_text())["kernels"]


def read(run):
    tr = run.trace
    if tr is None:
        return None
    v = tr.per_frame_us(lambda op: op["tag"] in TAGS)
    return v * 1e-3 if v > 0 else None
