"""The nadir render kernel B5 (`render_nadir_kernel`) against its roofline:
per update one render of the reset pool's P x B episodes and one of the B
envs at each decision, each bounded by the larger of its bytes (each once)
over the memory rate and its pixels' operations over the f32 peak, over
B5's device time per profiled update."""

from portbench.counts import landing, peaks

KERNEL = "render_nadir_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.device_s(KERNEL) <= 0:
        return None
    t = ctx.traffic
    b = t["num_envs"]
    bound = (t["rollout_steps"] * landing.render_bound_s(b, peaks.F32_FLOPS, peaks.HBM_BYTES)
             + landing.render_bound_s(t["reset_pool"] * b, peaks.F32_FLOPS, peaks.HBM_BYTES))
    return 100.0 * bound / (tr.device_s(KERNEL) / tr.steps)
