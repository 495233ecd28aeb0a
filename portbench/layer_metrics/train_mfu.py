"""The hover train step's model FLOP (`counts.hover.step_flops`: the
rollout's forward passes and K epochs of gradients, counted once) per
second over the unprofiled window, as a share of the card's TF32 peak, the
highest rate at which it multiplies float32 inputs."""

from portbench.counts import hover, peaks


def read(ctx):
    w, t, m = ctx.window, ctx.traffic, ctx.config["model"]
    if not w.steps:
        return None
    flops = hover.step_flops(t["num_envs"], t["rollout_steps"], ctx.config["ppo"]["k_epochs"],
                             m["obs_dim"], m["hidden"])
    return 100.0 * flops * w.steps / w.wall_s / peaks.TF32_FLOPS
