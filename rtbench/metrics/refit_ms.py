"""refit_ms: device time per profiled frame of the kernels launched in the
scene refit (``layers/refit.json``: ``refit_scene``, which an animated
configuration's frame calls before the frame function). None where
nothing ran there: a static scene refits nothing."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    v = tr.per_frame_us(lambda op: op["layer"] == "refit")
    return v * 1e-3 if v > 0 else None
