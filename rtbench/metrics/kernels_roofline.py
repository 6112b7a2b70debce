"""kernels_roofline: the hand-written kernels' share of their roofline, %:
the sum over the profiled frames' launches of B2, B8 and B9 of each
launch's least time (its operations over 67 TFLOP/s or its bytes over
3.35 TB/s, whichever is larger; ``bounds/<kernel>.py``) over the sum of
their device times. None where no bounded kernel ran, or where the trace
holds another number of their launches than were counted."""

from collections import Counter


def read(run):
    tr = run.trace
    if tr is None or not run.bound_kernels:
        return None
    tags = set(run.bound_kernels)
    ops = [op for op in tr.counted if op["tag"] in tags]
    if Counter(op["tag"] for op in ops) != Counter(run.bound_kernels):
        return None
    busy = sum(op["dur"] for op in ops) * 1e-6
    return 100.0 * run.bound_s / busy if busy > 0 else None
