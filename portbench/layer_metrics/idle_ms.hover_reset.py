"""Milliseconds of a step's device idle under the span ``hover.reset``, the
fresh episodes' reset inside ``hover.rollout`` on the row-major branch
(`portbench/spans.py`: the profiled split of the idle applied to the
unprofiled step's idle). None where the program opens no such span."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "hover.reset")
