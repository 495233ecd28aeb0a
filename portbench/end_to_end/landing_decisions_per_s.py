"""Landing decisions completed per second: envs x decisions per rollout x
the updates completed in the window, over the window's wall time (from the
first update's enqueue to the synchronization after the last)."""


def read(ctx):
    w = ctx.window
    return w.steps * ctx.work_per_step / w.wall_s if w.steps else None
