"""Double-loop LQR baseline: translation outer loop, attitude inner loop.

Counterpart of `baselines/lqr.py` in the JAX package (the reference's
lqr_quad.py:26-167): two continuous-time algebraic Riccati equations on
double-integrator models give constant gains K_t (translation: velocity
regulation) and K_att (attitude). They are solved once on the host with
scipy in float64, as the JAX package solves them, and cast to float32; the
control law runs batched on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.linalg import solve_continuous_are

from ..config import PhysicsConfig


class LQRGains(NamedTuple):
    k_t: torch.Tensor    # (3, 6) translation gains
    k_att: torch.Tensor  # (4, 6) attitude gains


def _double_integrator_a() -> np.ndarray:
    """A (6x6) of three decoupled double integrators (reference
    lqr_quad.py:67-80, 92-105)."""
    a = np.zeros((6, 6))
    a[0, 1] = a[2, 3] = a[4, 5] = 1.0
    return a


def make_lqr_gains(phys: PhysicsConfig | None = None, clipped: bool = True,
                   device=None) -> LQRGains:
    """Solve the two CAREs with the reference's Q/R weights (reference
    lqr_quad.py:26-62) and return K = -R^-1 B^T P as float32 tensors on
    ``device`` (the CPU when None)."""
    phys = phys or PhysicsConfig()
    if clipped:
        q_att = np.diag([5.0, 1.0, 5.0, 1.0, 0.05, 0.01]) * 50.0
        r_att = np.eye(4) * 40.0
        q_t = np.diag([1e-08, 1.0, 1e-08, 1.0, 1e-08, 0.8]) * 10.0
        r_t = np.eye(3) * 10.0
    else:
        q_att = np.diag([5.0, 0.3, 5.0, 0.3, 2.0, 0.3]) * 160.0
        r_att = np.eye(4) * 40.0
        q_t = np.diag([1e-08, 1.0, 1e-08, 1.0, 1e-08, 0.5]) * 60.0
        r_t = np.eye(3) * 5.0

    b_att = np.zeros((6, 4))
    b_att[1, 1] = 1.0 / phys.j_xx
    b_att[3, 2] = 1.0 / phys.j_yy
    b_att[5, 3] = 1.0 / phys.j_zz
    a = _double_integrator_a()
    p_att = solve_continuous_are(a, b_att, q_att, r_att)
    k_att = -np.linalg.inv(r_att) @ b_att.T @ p_att

    b_t = np.zeros((6, 3))
    b_t[1, 0] = b_t[3, 1] = b_t[5, 2] = 1.0 / phys.mass
    p_t = solve_continuous_are(a, b_t, q_t, r_t)
    k_t = -np.linalg.inv(r_t) @ b_t.T @ p_t

    as_t = lambda k: torch.as_tensor(k.astype(np.float32), device=device)
    return LQRGains(k_t=as_t(k_t), k_att=as_t(k_att))


def lqr_control(
    gains: LQRGains,
    vel: torch.Tensor,          # (B, 3) inertial velocity
    ang: torch.Tensor,          # (B, 3) Euler angles
    ang_vel: torch.Tensor,      # (B, 3) Euler rates
    euler_t_ant: torch.Tensor,  # (B, 3) previous desired attitude
    phys: PhysicsConfig,
    dt: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One LQR step -> (action (B, 4) [U1, Mx, My, Mz], new euler_t_ant).

    Mirrors the reference control loop (lqr_quad.py:131-160): the outer loop
    regulates velocity to zero (position entries zeroed, :133), converts the
    virtual force to a desired roll/pitch and collective thrust, and the
    inner loop tracks that attitude. The first action column is overwritten
    by U1 (:158): the attitude solve's thrust channel is discarded."""
    state_t = torch.zeros(vel.shape[0], 6, dtype=vel.dtype, device=vel.device)
    state_t[:, 1::2] = vel
    f = state_t @ gains.k_t.T

    g = phys.gravity
    theta_t = torch.atan2(f[:, 0], f[:, 2] + g)
    phi_t = torch.atan2(-f[:, 1] * torch.cos(theta_t), f[:, 2] + g)
    euler_t = torch.stack([phi_t, theta_t, torch.zeros_like(phi_t)], dim=-1)
    u1 = phys.mass * (f[:, 2] + g) / (torch.cos(theta_t) * torch.cos(phi_t))

    euler_err = ang - euler_t
    state_att = torch.stack([euler_err, ang_vel], dim=-1).reshape(-1, 6)
    action = state_att @ gains.k_att.T
    action = torch.cat([u1[:, None], action[:, 1:]], dim=-1)
    return action, euler_t
