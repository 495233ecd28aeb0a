"""The share of a train step in which no operation ran on the device:
1 - (busy seconds per profiled step) / (wall seconds per unprofiled step).
The busy time is the union of the device operations' intervals in the steps
profiled after the window; the step's length is the unprofiled window's
wall time over its steps, since the profiler slows the host and would
stretch the profiled steps' own wall time. Reads `device_idle_share.hover`
and `device_idle_share.landing`."""


def read(ctx):
    tr, w = ctx.trace, ctx.window
    if tr is None or not tr.device or not w.steps:
        return None
    return 100.0 * (1.0 - (tr.busy_s() / tr.steps) / (w.wall_s / w.steps))
