"""Visual-landing reward: dense shaping + discrete terminal taxonomy.

Counterpart of `landing/reward.py` in the JAX package (the reference's
`visual_reward`, visual_landing/rl_reward_fuction.py:3-102), on a batch of
envs. Constants verbatim:

  shaping  = -4 * (2*error_xy + error_z)                      (:59)
  step     = shaping delta - 0.1*|control|                    (:68-72)
  terminal (checked in this order, :75-96):
    landed (z <= -4.95):
      soft (|v| < |(.3,.3,.3)|) & flat (|rp| < |(.349,.349)| and
      |w| < |(1,1)|) & on-target (exy < 0.14)  ->  +5, solved
      soft & flat                              ->  +1
      soft, not flat                           ->   0
      hard                                     ->  -1
    astray (exy > ez*5/7 + 0.2 or ez > 7)      ->  -5
    timeout (step > total)                     ->  -2   (overrides landed)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

ERROR_P = 4.0
CONTROL_P = 0.1
SOFT_VEL = math.sqrt(3.0) * 0.30       # |(.3,.3,.3)|
FLAT_ANG = math.sqrt(2.0) * 0.3491     # |(.3491,.3491)|
FLAT_RATE = math.sqrt(2.0) * 1.0
ON_TARGET_XY = 0.14
LANDED_Z = -4.95
ASTRAY_Z = 7.0
TIMEOUT_REWARD = -2.0
MARKER_Z_SHIFT = 5.0                   # world -> env frame (reference :50)


class VisualRewardOut(NamedTuple):
    reward: torch.Tensor   # (B,)
    shaping: torch.Tensor  # (B,)
    done: torch.Tensor     # (B,) bool
    solved: torch.Tensor   # (B,) bool


def visual_reward(
    total_steps: int,
    marker_position: torch.Tensor,  # (B, 3) WORLD frame (z ~ 0.001)
    quad_position: torch.Tensor,    # (B, 3) env frame
    quad_vel: torch.Tensor,         # (B, 3)
    control: torch.Tensor,          # (B, 3) the CNN's raw action
    last_shaping: torch.Tensor,     # (B,)
    has_shaping: torch.Tensor,      # (B,) bool: the reference's `if last_shaping:`
    step: torch.Tensor,             # (B,) int internal physics frame
    ang: torch.Tensor,              # (B, 3) Euler angles
    v_ang: torch.Tensor,            # (B, 3) body rates
) -> VisualRewardOut:
    dtype = quad_position.dtype
    norm = lambda v: torch.linalg.vector_norm(v, dim=-1)
    marker_z_env = marker_position[:, 2] - MARKER_Z_SHIFT

    error_xy = norm(marker_position[:, 0:2] - quad_position[:, 0:2])
    error_z = torch.abs(marker_z_env - quad_position[:, 2])
    vel = norm(quad_vel)
    control_effort = norm(control)

    shaping = -ERROR_P * (error_xy * 2.0 + error_z)

    soft = vel < SOFT_VEL
    landed = quad_position[:, 2] <= LANDED_Z
    on_target = error_xy < ON_TARGET_XY
    flat = (norm(ang[:, 0:2]) < FLAT_ANG) & (norm(v_ang) < FLAT_RATE)
    astray = (error_xy > error_z / 7.0 * 5.0 + 0.2) | (error_z > ASTRAY_Z)
    timeout = step > total_steps

    base = torch.where(has_shaping, shaping - last_shaping, torch.zeros_like(shaping))
    reward = base - CONTROL_P * control_effort

    const = lambda v: torch.full_like(shaping, v)
    landed_reward = torch.where(
        soft, torch.where(flat, torch.where(on_target, const(5.0), const(1.0)), const(0.0)),
        const(-1.0),
    )
    solved = landed & soft & flat & on_target

    reward = torch.where(landed, landed_reward, torch.where(astray, const(-5.0), reward))
    # reference :93-95: the timeout branch runs last and overrides
    reward = torch.where(timeout, const(TIMEOUT_REWARD), reward).to(dtype)

    done = landed | astray | timeout
    return VisualRewardOut(reward=reward, shaping=shaping, done=done, solved=solved)
