"""Milliseconds in which an operation ran on the device, per train step:
the union of the device operations' intervals over the steps profiled
after the window, over their count. The window's rate follows the host's
pace as well as the card's; this reads the card's own work alone. Reads
`device_busy_ms.landing`."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not tr.steps:
        return None
    return 1e3 * tr.busy_s() / tr.steps
