"""pathtrace_ms: device time per profiled frame of the kernels launched in
the path trace of ``render_frame_restir`` (the range of ``layers/frame.json``'s
``trace``, "path trace (B8, B9)": the ``restir_di`` frame's indirect light,
the wavefront ``ops.pathtracer.trace_reference`` on a clustered scene), the
ray queries' B8/B9 left out. None where no path trace ran."""

import json
from pathlib import Path

STAGE = "rtbench.stage.frame:path trace (B8, B9)"
RAY_QUERIES = json.loads((Path(__file__).resolve().parent.parent / "layers" / "rayquery.json")
                         .read_text())["kernels"]


def read(run):
    tr = run.trace
    if tr is None:
        return None
    v = tr.per_frame_us(lambda op: op["stage"] == STAGE and op["tag"] not in RAY_QUERIES)
    return v * 1e-3 if v > 0 else None
