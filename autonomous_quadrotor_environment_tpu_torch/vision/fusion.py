"""Complementary-filter fusion of vision pose into the INS dead-reckoning.

Counterpart of `vision/fusion.py` in the JAX package (the reference's
fusion block, computer_vision/quadrotor_cv.py:90-99), batched over a
leading episode axis E: every vision fix blends

    position_t0   <- 0.8 * position_t0   + 0.2 * vision_position
    quaternion_t0 <- 0.8 * quaternion_t0 + 0.2 * vision_quaternion
    velocity_t0   <- 0.9 * velocity_t0   + 0.1 * vision_velocity
                     (only when the vision-velocity variance over the last
                      window is < 0.1 and >50 samples accumulated)

The reference's deque(maxlen=100) variance gate is a fixed ring buffer per
episode, written by a scatter at each episode's own slot, so that an update
reads nothing on the host and runs inside a CUDA graph.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..envs.sensors import SensorState

WINDOW = 100
MIN_SAMPLES = 50
POS_ALPHA = 0.8
QUAT_ALPHA = 0.8
VEL_ALPHA = 0.9
VAR_GATE = 0.1


class VisionFusionState(NamedTuple):
    prev_pos: torch.Tensor    # (E, 3) last vision position fix
    prev_valid: torch.Tensor  # (E,) bool
    prev_step: torch.Tensor   # (E,) int32 env step of the last fix
    vel_ring: torch.Tensor    # (E, WINDOW, 3) vision-velocity history
    count: torch.Tensor       # (E,) int32 fixes accumulated


def vision_fusion_init(episodes: int, dtype=torch.float32, device=None) -> VisionFusionState:
    return VisionFusionState(
        prev_pos=torch.zeros(episodes, 3, dtype=dtype, device=device),
        prev_valid=torch.zeros(episodes, dtype=torch.bool, device=device),
        prev_step=torch.zeros(episodes, dtype=torch.int32, device=device),
        vel_ring=torch.zeros(episodes, WINDOW, 3, dtype=dtype, device=device),
        count=torch.zeros(episodes, dtype=torch.int32, device=device),
    )


def vision_fuse(
    fstate: VisionFusionState,
    sens: SensorState,
    vision_pos: torch.Tensor,   # (E, 3) env-frame position from PnP
    vision_quat: torch.Tensor,  # (E, 4) attitude from PnP
    ok: torch.Tensor,           # (E,) detection success flags
    step_i: torch.Tensor,       # () or (E,) integer env step
    dt: float,
) -> tuple[VisionFusionState, SensorState]:
    """One fusion update; the identity on every episode whose ``ok`` is
    False."""
    dtype = vision_pos.dtype
    step_i = step_i.to(torch.int32).expand_as(fstate.prev_step)
    dstep = torch.clamp_min(step_i - fstate.prev_step, 1).to(dtype)
    vel = (vision_pos - fstate.prev_pos) / (dt * dstep)[:, None]
    have_vel = ok & fstate.prev_valid

    slot = torch.remainder(fstate.count, WINDOW).long()
    written = fstate.vel_ring.scatter(1, slot[:, None, None].expand(-1, 1, 3), vel[:, None, :])
    ring = torch.where(have_vel[:, None, None], written, fstate.vel_ring)
    count = torch.where(have_vel, fstate.count + 1, fstate.count)

    n_valid = torch.clamp_max(count, WINDOW)
    denom = torch.clamp_min(n_valid.to(dtype), 1.0)[:, None]
    mask = (torch.arange(WINDOW, device=count.device) < n_valid[:, None])[..., None]
    mean = torch.sum(ring * mask, dim=1) / denom
    var = torch.sum(((ring - mean[:, None, :]) ** 2) * mask, dim=1) / denom
    gate = have_vel & (torch.mean(var, dim=-1) < VAR_GATE) & (count > MIN_SAMPLES)

    okc = ok[:, None]
    pos = torch.where(okc, sens.pos_ins * POS_ALPHA + vision_pos * (1 - POS_ALPHA), sens.pos_ins)
    quat = torch.where(
        okc, sens.quat_ins * QUAT_ALPHA + vision_quat * (1 - QUAT_ALPHA), sens.quat_ins
    )
    vel_ins = torch.where(gate[:, None], sens.vel_ins * VEL_ALPHA + vel * (1 - VEL_ALPHA),
                          sens.vel_ins)

    new_f = VisionFusionState(
        prev_pos=torch.where(okc, vision_pos, fstate.prev_pos),
        prev_valid=ok | fstate.prev_valid,
        prev_step=torch.where(ok, step_i, fstate.prev_step),
        vel_ring=ring,
        count=count,
    )
    return new_f, sens.replace(pos_ins=pos, quat_ins=quat, vel_ins=vel_ins)
