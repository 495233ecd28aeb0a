"""Env-steps completed per second: envs x rollout steps x the train steps
completed in the window, over the window's wall time (from the first step's
enqueue to the synchronization after the last)."""


def read(ctx):
    w = ctx.window
    return w.steps * ctx.work_per_step / w.wall_s if w.steps else None
