"""launches_per_frame: CUDA kernels launched per profiled frame (the
bounds' own reductions left out)."""


def read(run):
    tr = run.trace
    return tr.kernels_per_frame() if tr is not None and tr.counted else None
