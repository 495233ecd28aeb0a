"""Milliseconds of a step's device idle under the span ``hover.inputs``
(`portbench/spans.py`: the profiled split of the idle applied to the
unprofiled step's idle)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "hover.inputs")
