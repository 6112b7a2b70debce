"""host_enqueue_ms: the host's time in each frame call (``Port.frame``:
``render_frame_restir``, after the clip's refit on an animated scene; host
clock, no synchronise), the mean over the traced run's window frames
outside the profiled ones (the profiler slows the host)."""


def read(run):
    ms = run.untraced_host_ms
    return sum(ms) / len(ms) if ms else None
