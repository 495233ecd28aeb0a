"""The whole-rollout kernel B1 (`rollout_kernel`) against its roofline: the
least time of one rollout, the larger of its forward passes' FLOP over the
TF32 peak and its bytes (each once) over the memory rate, over B1's device
time per profiled step."""

from portbench.counts import hover, peaks

KERNEL = "rollout_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.device_s(KERNEL) <= 0:
        return None
    t, m = ctx.traffic, ctx.config["model"]
    b, steps = t["num_envs"], t["rollout_steps"]
    bound = max(hover.rollout_flops(b, steps, m["obs_dim"], m["hidden"]) / peaks.TF32_FLOPS,
                hover.rollout_bytes(b, steps, t["fused_pool"], m["obs_dim"], m["hidden"])
                / peaks.HBM_BYTES)
    return 100.0 * bound / (tr.device_s(KERNEL) / tr.steps)
