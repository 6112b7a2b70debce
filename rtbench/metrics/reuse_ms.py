"""reuse_ms: device time per profiled frame of the kernels launched in the
reuse passes (``layers/reuse.json``), the ray queries' B8/B9 left out."""

import json
from pathlib import Path

RAY_QUERIES = json.loads((Path(__file__).resolve().parent.parent / "layers" / "rayquery.json")
                         .read_text())["kernels"]


def read(run):
    tr = run.trace
    if tr is None:
        return None
    v = tr.per_frame_us(lambda op: op["layer"] == "reuse" and op["tag"] not in RAY_QUERIES)
    return v * 1e-3 if v > 0 else None
