"""post_ms: device time per profiled frame of the kernels launched in the
post passes (``layers/post.json``: a-trous, TAA or TAAU and RCAS, exposure,
tonemap, sRGB)."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    v = tr.per_frame_us(lambda op: op["layer"] == "post")
    return v * 1e-3 if v > 0 else None
