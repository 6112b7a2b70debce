"""device_idle_pct: 100 x (1 - the union of the device operations'
intervals / the profiled frames' span), the span running from the end of
the lead-in frame's last device operation to the end of the last profiled
frame's."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
