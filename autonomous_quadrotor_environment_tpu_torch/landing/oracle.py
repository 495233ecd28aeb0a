"""Oracle PI landing policy: the upper-bound baseline.

Counterpart of `landing/oracle.py` in the JAX package (the reference's
`math_trajectory.py`, visual_landing/math_trajectory.py:46-160): a PI(4.5,
0.5, 0) position controller that KNOWS the marker position commands a
clipped velocity error through the same frozen low-level controller at
every physics step, with the JAX package's flare limiter on the descent
speed, scored by `visual_reward`. It renders nothing and runs no CNN, so it
tests the frozen controller and the landing geometry apart from the render
kernel and the convolutions.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..core.quaternion import deriv_quat, quat_normalize
from ..envs import hover
from ..envs.featurizer import feat_size, push_hist
from .env import LandingConfigs, ResetDraws, draw_reset, start_geometry
from .reward import visual_reward

PI_P = 4.5
PI_D = 0.5
VEL_CLIP_LO = (-0.5, -0.5, -1.666)
VEL_CLIP_HI = (0.5, 0.5, 0.333)
# Flare profile: the commanded descent speed is capped by the
# constant-deceleration landing curve v(h) = sqrt(v_td^2 + 2 a h).
FLARE_V_TD = 0.2   # target touchdown speed [m/s]
FLARE_ACCEL = 1.0  # assumed achievable deceleration [m/s^2]


def _quat_state(x: torch.Tensor) -> torch.Tensor:
    """(B, 14) [pos/vel, quat, quat_dot], the env's step output (reference
    quadrotor_env_opt.py:399-400)."""
    q = quat_normalize(x[:, 6:10])
    return torch.cat([x[:, 0:10], deriv_quat(x[:, 10:13], q)], dim=-1)


@torch.no_grad()
def oracle_landing_eval(
    ctrl_model: Any,
    cfgs: LandingConfigs,
    episodes: int,
    gen: Optional[torch.Generator] = None,
    *,
    draws: Optional[ResetDraws] = None,
) -> dict:
    """Batched oracle benchmark over ``total_steps`` physics steps: solved
    fraction, mean landing time, mean cumulative |v| and finished fraction
    (the reference's solved/time/delta_v printout :157-160), as 0-d
    tensors. The start draws (marker, z, xy; the drift rates are unused)
    come from ``gen`` unless given."""
    lcfg = cfgs.landing
    dtype = torch.float32
    if draws is None:
        draws = draw_reset(gen, episodes, dtype)
    marker_world, x0 = start_geometry(draws, cfgs)
    device = x0.device
    const = lambda v: torch.tensor(v, dtype=dtype, device=device)
    scale, vel_d = const(lcfg.velocity_scale), const(lcfg.velocity_d)
    clip_lo, clip_hi = const(VEL_CLIP_LO), const(VEL_CLIP_HI)
    marker_env = torch.cat([marker_world[:, 0:2], torch.full_like(marker_world[:, :1], -5.0)], -1)

    env_s = hover.reset(None, cfgs.env, det_state=x0, dtype=dtype)
    b = x0.shape[0]
    hist = push_hist(torch.zeros(b, feat_size(5), dtype=dtype, device=device),
                     _quat_state(env_s.x), torch.zeros(b, 4, dtype=dtype, device=device))
    falses = torch.zeros(b, dtype=torch.bool, device=device)
    last_shaping = torch.zeros(b, dtype=dtype, device=device)
    has_shaping, done, solved = falses, falses, falses
    t_done = torch.zeros_like(last_shaping)
    dv = torch.zeros_like(last_shaping)
    for k in range(lcfg.total_steps):
        action = ctrl_model.actor_mean(hist)
        env_s2, _ = hover.step(env_s, action, cfgs.env)
        s, ds = env_s2.x[:, 0:5:2], env_s2.x[:, 1:6:2]
        vel_error = PI_P * (marker_env - s) + PI_D * (-ds)
        vel_error = torch.clamp(vel_error, clip_lo, clip_hi)
        h = torch.clamp_min(s[:, 2] - lcfg.ground_z, 0.0)
        v_lim = torch.sqrt(FLARE_V_TD**2 + 2.0 * FLARE_ACCEL * h)
        vel_error = torch.cat(
            [vel_error[:, 0:2], torch.maximum(vel_error[:, 2], -v_lim)[:, None]], dim=-1
        )
        control = (vel_error - vel_d) / scale

        err14 = torch.zeros(b, 14, dtype=dtype, device=device)
        err14[:, 1:6:2] = vel_error
        hist2 = push_hist(hist, _quat_state(env_s2.x) - err14, action)

        step = torch.full((b,), k, dtype=torch.int32, device=device)
        rew = visual_reward(
            lcfg.total_steps, marker_world, s, ds, control, last_shaping, has_shaping, step,
            env_s2.ang, env_s2.x[:, 10:13],
        )
        newly_done = ~done & rew.done
        solved = solved | (newly_done & rew.solved)
        t_done = torch.where(newly_done, step.to(dtype) * cfgs.env.dt, t_done)
        dv = dv + torch.where(done, 0.0, torch.sum(torch.abs(ds), dim=-1))
        done = done | rew.done
        # freeze each env once done
        env_s = hover.where_done(done, env_s, env_s2)
        hist = torch.where(done[:, None], hist, hist2)
        last_shaping, has_shaping = rew.shaping, torch.ones_like(falses)
    return {
        "oracle_solved": solved.float().mean(),
        "oracle_time_s": t_done.mean(),
        "oracle_delta_v": dv.mean(),
        "oracle_finished": done.float().mean(),
    }
