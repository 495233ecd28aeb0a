"""Seconds from the process's start to the first timed step: imports, the
card's start, kernel builds (on a checkout's first run), weights and envs
from the seed, and the set-up train steps, which warm up every shape."""


def read(ctx):
    return ctx.setup_s
