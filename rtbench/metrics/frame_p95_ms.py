"""frame_p95_ms: the 95th percentile of every frame interval of the window:
the device time between consecutive frames' end events, the first from the
window's start (CUDA events; ``statistics.quantiles``, exclusive method)."""

import statistics


def read(run):
    iv = run.intervals_ms
    return statistics.quantiles(iv, n=20)[-1] if len(iv) >= 20 else None
