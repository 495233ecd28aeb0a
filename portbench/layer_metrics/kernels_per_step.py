"""Kernels the device ran per profiled train step (copies and sets not
counted), from the profiler's device rows. Reads `kernels_per_step.hover`."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.kernels():
        return None
    return len(tr.kernels()) / tr.steps
