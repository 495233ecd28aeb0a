"""The share of the profiled steps' device idle that falls under a layer's
span (`portbench/spans.py`), as opposed to the whole step's span alone
(``hover.step``, ``landing.step``) or no span. Reads
`idle_named_share.hover` and `idle_named_share.landing`."""

from portbench import spans


def read(ctx):
    return spans.named_share(ctx)
