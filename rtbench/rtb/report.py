"""A run's result line: the cell's metrics read by their readers, the
device record, the breakdown of a traced run and the numbers compared."""

from __future__ import annotations

import torch

from . import loop, spec


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, t0: float, device,
             frame_hook=None) -> dict:
    """Run ``cell`` and build its result: ``line`` (the JSON object the run
    prints last), ``rows`` ([name, value, limit] of the numbers compared)
    and ``info`` (lines printed before it)."""
    res = loop.run(cell, seed, seconds, trace, t0, device, frame_hook=frame_hook)
    run = res["run"]
    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = spec.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": res["memory_peak_bytes"]}
    # a frame checked is failed where one of its numbers is not within its limit (or NaN)
    failed = {n.split(".")[0] for n, v, lim in res["rows"] if not v <= lim}
    line = {"correct": res["correct"], "attempted": run.frames, "failed": len(failed),
            "metrics": metrics, "device": dev}
    info = [f"frames {run.frames} in {run.window_s!r} s; set-up {run.setup_s!r} s; "
            f"peak {res['memory_peak_bytes']} bytes; reference check {res['reference_s']!r} s"]
    if trace and run.trace is not None:
        tr = run.trace
        dev.update(busy_s=tr.busy_us() * 1e-6, window_s=tr.window_us * 1e-6)
        line["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        info.append(f"traced frames {tr.frames}; {len(tr.counted)} device operations")
    info += [f"{k} {v!r}" for k, v in sorted(res["values"].items())]
    line["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in res["rows"]}
    return dict(line=line, rows=res["rows"], info=info)
