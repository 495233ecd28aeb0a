"""Cascaded PID controllers (position and velocity regulation), batched.

Counterpart of `baselines/pid.py` in the JAX package (the reference's
PID_control.py:24-106, position tracking with true-derivative PID, and
pid_vel_control.py:18-127, velocity regulation with
derivative-on-measurement), over a batch of quadrotors: every state leaf
has the batch as its first axis.

Structure (reference PID_control.py:46-93):
  lower loop: position/velocity errors -> desired (thrust U1, roll, pitch)
  upper loop: attitude errors -> body moments via the inverse Euler-rate
              inertia matrix
Action = [U1, Mx, My, Mz], for the env in indirect-control mode.

The 3x3 Euler-rate inertia system is solved in closed form: its first
column is (1/j_xx, 0, 0), so the moments come from its lower 2x2 block and
one back substitution, with no host synchronization (a CUDA graph can hold
it).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import PhysicsConfig


class PIDGains(NamedTuple):
    """Per-axis gains (reference PID_control.py:24-27 /
    pid_vel_control.py:18-27)."""

    pos: tuple = (6.0, 0.0, 3.0)      # x & y (P, I, D)
    pos_z: tuple = (6.0, 0.0, 3.0)
    ang: tuple = (22.0, 0.0, 12.0)    # roll & pitch
    ang_psi: tuple = (1.0, 0.0, 0.1)
    deriv_on_measurement: bool = False


POSITION_GAINS = PIDGains()
VELOCITY_GAINS = PIDGains(
    pos=(1.0, -0.0, 0.0),
    pos_z=(0.4, -0.0, 0.0),
    ang=(20.0, 0.0, 20.0),
    ang_psi=(5.0, 0.0, 5.0),
    deriv_on_measurement=True,
)
VELOCITY_GAINS_UNCLIPPED = PIDGains(
    pos=(2.0, -0.0, 0.0),
    pos_z=(1.0, -0.0, 0.0),
    ang=(180.0, 0.0, 50.0),
    ang_psi=(40.0, 0.0, 20.0),
    deriv_on_measurement=True,
)


@dataclasses.dataclass
class PIDState:
    """One scalar PID loop's carry per env (reference `pid` class
    PID_control.py:205-216): integral accumulator and previous measurement
    for derivative-on-measurement mode (pid_vel_control.py:113-127)."""

    ix: torch.Tensor     # (B,) integral of error
    x_old: torch.Tensor  # (B,) previous measurement


def pid_init(n: int, dtype=torch.float32, device=None) -> PIDState:
    z = torch.zeros(n, dtype=dtype, device=device)
    return PIDState(ix=z, x_old=z)


def pid_step(
    s: PIDState,
    x: torch.Tensor,
    dx: torch.Tensor,
    x_d: torch.Tensor,
    dx_d: torch.Tensor,
    gains: tuple,
    dt: float,
    deriv_on_measurement: bool = False,
) -> tuple[PIDState, torch.Tensor]:
    """u = P(x_d - x) + D(dx_d - dx) - I*integral (reference sign convention,
    PID_control.py:213-215). In derivative-on-measurement mode `dx` is
    recomputed as (x - x_old)/dt (pid_vel_control.py:121-122)."""
    p, i, d = gains
    if deriv_on_measurement:
        dx = (x - s.x_old) / dt
    ix = s.ix + (x_d - x) * dt
    u = p * (x_d - x) + d * (dx_d - dx) - i * ix
    return PIDState(ix=ix, x_old=x), u


@dataclasses.dataclass
class CascadedPIDState:
    """All six loops and the previous desired attitude (for its
    finite-difference rate, reference PID_control.py:100-104)."""

    x: PIDState
    y: PIDState
    z: PIDState
    phi: PIDState
    theta: PIDState
    psi: PIDState
    ang_d_ant: torch.Tensor  # (B, 3)


def cascaded_pid_init(n: int, dtype=torch.float32, device=None) -> CascadedPIDState:
    loops = [pid_init(n, dtype, device) for _ in range(6)]
    return CascadedPIDState(*loops, ang_d_ant=torch.zeros(n, 3, dtype=dtype, device=device))


def _euler_rate_inertia(ang: torch.Tensor, phys: PhysicsConfig) -> torch.Tensor:
    """The M matrices (B, 3, 3) mapping moments to Euler-rate accelerations
    (reference PID_control.py:72-90)."""
    phi, theta = ang[:, 0], ang[:, 1]
    sp, cp = torch.sin(phi), torch.cos(phi)
    ct, tt = torch.cos(theta), torch.tan(theta)
    z = torch.zeros_like(phi)
    return torch.stack(
        [
            torch.stack([1.0 / phys.j_xx + z, tt * sp / phys.j_yy, tt * cp / phys.j_zz], -1),
            torch.stack([z, cp / phys.j_yy, -sp / phys.j_zz], -1),
            torch.stack([z, sp / ct / phys.j_yy, cp / ct / phys.j_zz], -1),
        ],
        dim=-2,
    )


def _solve_euler_rate(m: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``solve(m, u)`` for the (B, 3, 3) matrices of `_euler_rate_inertia`
    (zeros below the first diagonal entry) and right-hand sides (B, 3)."""
    a11, a12, a21, a22 = m[:, 1, 1], m[:, 1, 2], m[:, 2, 1], m[:, 2, 2]
    det = a11 * a22 - a12 * a21
    m2 = (a22 * u[:, 1] - a12 * u[:, 2]) / det
    m3 = (a11 * u[:, 2] - a21 * u[:, 1]) / det
    m1 = (u[:, 0] - m[:, 0, 1] * m2 - m[:, 0, 2] * m3) / m[:, 0, 0]
    return torch.stack([m1, m2, m3], dim=-1)


def cascaded_pid_control(
    s: CascadedPIDState,
    pos: torch.Tensor,      # (B, 3) current position (or velocity in vel mode)
    vel: torch.Tensor,      # (B, 3) its derivative (ignored in deriv-on-meas.)
    ang: torch.Tensor,      # (B, 3) Euler angles
    ang_vel: torch.Tensor,  # (B, 3) Euler rates
    xd: torch.Tensor,       # (B, 3) position (or velocity) target
    dxd: torch.Tensor,      # (B, 3) target derivative
    psi_d: torch.Tensor,    # (B,) desired yaw
    gains: PIDGains,
    phys: PhysicsConfig,
    dt: float,
) -> tuple[CascadedPIDState, torch.Tensor]:
    """One control step -> action (B, 4) [U1, Mx, My, Mz]
    (reference PID_control.py:95-106 / pid_vel_control.py:99-110).

    The position variant uses atan (reference :57-59), the velocity variant
    atan2 with the cos inside the numerator (:60-62), selected by
    ``gains.deriv_on_measurement`` as in the JAX package."""
    dom = gains.deriv_on_measurement
    sx, u1 = pid_step(s.x, pos[:, 0], vel[:, 0], xd[:, 0], dxd[:, 0], gains.pos, dt, dom)
    sy, u2 = pid_step(s.y, pos[:, 1], vel[:, 1], xd[:, 1], dxd[:, 1], gains.pos, dt, dom)
    sz, u3 = pid_step(s.z, pos[:, 2], vel[:, 2], xd[:, 2], dxd[:, 2], gains.pos_z, dt, dom)

    g = phys.gravity
    if dom:
        theta_d = torch.atan2(u1, u3 + g)
        phi_d = torch.atan2(-u2 * torch.cos(theta_d), u3 + g)
    else:
        theta_d = torch.atan(u1 / (u3 + g))
        phi_d = torch.atan(-u2 / (u3 + g) * torch.cos(theta_d))
    big_u1 = phys.mass * (u3 + g) / (torch.cos(theta_d) * torch.cos(phi_d))

    ang_d = torch.stack([phi_d, theta_d, psi_d], dim=-1)
    v_ang_d = (ang_d - s.ang_d_ant) / dt

    # In the velocity variant the reference's `pid` class recomputes the
    # derivative from the measurement in every loop, attitude included
    # (pid_vel_control.py:121-122); the position variant uses the passed
    # rate (PID_control.py:213-215).
    sphi, u5 = pid_step(s.phi, ang[:, 0], ang_vel[:, 0], ang_d[:, 0], v_ang_d[:, 0],
                        gains.ang, dt, dom)
    sth, u6 = pid_step(s.theta, ang[:, 1], ang_vel[:, 1], ang_d[:, 1], v_ang_d[:, 1],
                       gains.ang, dt, dom)
    sps, u7 = pid_step(s.psi, ang[:, 2], ang_vel[:, 2], ang_d[:, 2], v_ang_d[:, 2],
                       gains.ang_psi, dt, dom)

    moments = _solve_euler_rate(_euler_rate_inertia(ang, phys), torch.stack([u5, u6, u7], -1))
    new_state = CascadedPIDState(x=sx, y=sy, z=sz, phi=sphi, theta=sth, psi=sps, ang_d_ant=ang_d)
    return new_state, torch.cat([big_u1[:, None], moments], dim=-1)
