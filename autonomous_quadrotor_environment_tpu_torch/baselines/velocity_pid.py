"""Outer velocity-error PID for mission tracking with the RL controller.

Counterpart of `baselines/velocity_pid.py` in the JAX package (the
reference's vel_pid, environment/controller/velocity_pid.py:3-35), batched:
it turns the position error against a mission target into a velocity-error
pseudo-state that is added to the RL controller's input offset.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import const

P_GAINS = (3.0, 3.0, 3.0)
I_GAINS = (0.0, 0.0, 0.0)
D_GAINS = (0.05, 0.05, 0.05)


@dataclasses.dataclass
class VelPIDState:
    cumm_error: torch.Tensor   # (B, 3)
    prev_pos_d: torch.Tensor   # (B, 3) previous target position
    prev_pos: torch.Tensor     # (B, 3) previous measured position


def vel_pid_init(n: int, dtype=torch.float32, device=None) -> VelPIDState:
    z = torch.zeros(n, 3, dtype=dtype, device=device)
    return VelPIDState(cumm_error=z, prev_pos_d=z, prev_pos=z)


def vel_pid(
    s: VelPIDState,
    state: torch.Tensor,    # (B, 13+) env state, position at [0:5:2]
    target: torch.Tensor,   # (B, 14) mission target, position at [0:5:2]
    dt: float = 0.01,
) -> tuple[VelPIDState, torch.Tensor]:
    """Returns (new_state, (B, 14) state_error with the velocity slots
    filled) (reference velocity_pid.py:16-35)."""
    position_d = target[:, 0:5:2]
    position = state[:, 0:5:2]
    err = position_d - position
    cumm = s.cumm_error + err * dt
    derivative = (err - (s.prev_pos_d - s.prev_pos)) / dt
    p = const(P_GAINS, err.dtype, err.device) * err
    i = const(I_GAINS, err.dtype, err.device) * cumm
    d = const(D_GAINS, err.dtype, err.device) * derivative
    err_vel = p + i + d
    state_error = torch.zeros(err.shape[0], 14, dtype=err.dtype, device=err.device)
    state_error[:, 1:6:2] = err_vel
    return VelPIDState(cumm_error=cumm, prev_pos_d=position_d, prev_pos=position), state_error
