"""The landing train step's model FLOP (`counts.landing.step_flops`: the
CNN's forward passes in the rollout and K epochs of forward and backward,
the frozen controller in every frame, counted once) per second over the
unprofiled window, as a share of the card's bf16 peak: the convolutions and
dense layers run in bf16."""

from portbench.counts import landing, peaks


def read(ctx):
    w, t = ctx.window, ctx.traffic
    if not w.steps:
        return None
    flops = landing.step_flops(t["num_envs"], t["rollout_steps"], t["reset_pool"],
                               ctx.config["ppo"]["k_epochs"], ctx.config["frames_per_decision"])
    return 100.0 * flops * w.steps / w.wall_s / peaks.BF16_FLOPS
