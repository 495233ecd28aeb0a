"""The transposed PPO gradient kernel B2 (`ppo_grad_kernel` and its
reduction pass `reduce_kernel`) against its roofline: per minibatch launch
the larger of the gradient's FLOP over the TF32 peak and its bytes (each
once) over the memory rate, summed over a step's K x minibatches launches,
over B2's device time per profiled step."""

from portbench.counts import hover, peaks

KERNELS = ("ppo_grad_kernel", "reduce_kernel")


def read(ctx):
    tr = ctx.trace
    device = 0.0 if tr is None else sum(tr.device_s(k) for k in KERNELS)
    if device <= 0:
        return None
    t, m = ctx.traffic, ctx.config["model"]
    n = t["num_envs"] * t["rollout_steps"]
    mb = min(t["minibatch_size"], n) if t["minibatch_size"] > 0 else n
    launches = ctx.config["ppo"]["k_epochs"] * (n // mb)
    tile = t["shuffle_block"]
    per = max(mb * hover.grad_flops_per_row(m["obs_dim"], m["hidden"]) / peaks.TF32_FLOPS,
              hover.grad_bytes(mb, mb // tile, m["obs_dim"], m["hidden"]) / peaks.HBM_BYTES)
    return 100.0 * launches * per / (device / tr.steps)
