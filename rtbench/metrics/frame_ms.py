"""frame_ms: the window's length (host clock, from the first timed frame's
submission to the end of the last frame started within ``--seconds``)
over the frames completed in it."""


def read(run):
    return run.window_s / run.frames * 1e3 if run.frames else None
