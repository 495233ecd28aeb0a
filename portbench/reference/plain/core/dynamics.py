"""Quaternion rigid-body quadrotor dynamics on batched tensors.

Counterpart of `core/dynamics.py` in the JAX package: the same ODE
right-hand side, fixed-step RK4 and motor models, written for a batch of
envs along the first axis instead of `vmap`.

State layout (B, 13): [x, vx, y, vy, z, vz, q0, q1, q2, q3, wx, wy, wz]
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import PhysicsConfig
from ..device import const
from .quaternion import deriv_quat, quat_normalize, quat_rot_mat
from .randomization import DomainParams


class MotorOutput(NamedTuple):
    """Resolved per-step motor quantities."""

    w: torch.Tensor               # (B, 4) propeller angular velocities [rad/s]
    thrust: torch.Tensor          # (B,)   total body-z thrust [N]
    moment: torch.Tensor          # (B, 3) body moments [N*m]
    step_effort: torch.Tensor     # (B, 4) normalized [-1,1] per-motor effort
    clipped_action: torch.Tensor  # (B, 4) action after saturation


def _allocation_matrix(phys: PhysicsConfig) -> np.ndarray:
    """Motor allocation matrix mapping u = w^2 to [F, Mx, My, Mz]."""
    kf, km, d = phys.k_f, phys.k_m, phys.d_arm
    return np.array(
        [
            [kf, kf, kf, kf],
            [-d * kf, 0.0, d * kf, 0.0],
            [0.0, d * kf, 0.0, -d * kf],
            [-km, km, -km, km],
        ]
    )


def f2w(
    f: torch.Tensor,
    m: torch.Tensor,
    phys: PhysicsConfig,
    dom: DomainParams,
    clipped: bool = True,
    randomize: bool = False,
) -> MotorOutput:
    """Indirect control: body thrust (B,) + moments (B, 3) -> motor speeds,
    with saturation; ``u = w^2`` solves the constant allocation system."""
    alloc = _allocation_matrix(phys)
    rows = lambda a: tuple(map(tuple, a.tolist()))
    x_mat = const(rows(alloc), f.dtype, f.device)
    x_inv = const(rows(np.linalg.inv(alloc)), f.dtype, f.device)
    y = torch.cat([f[:, None], m], dim=-1)
    u = y @ x_inv.T
    u_max = phys.max_motor_thrust / phys.k_f
    if clipped:
        u = torch.clamp(u, 0.0, u_max)
        w = torch.sqrt(u)
    else:
        w = torch.sign(u) * torch.sqrt(torch.abs(u))
    if randomize:
        u = u - u * dom.kf_degrade
    fm_new = u @ x_mat.T
    step_effort = u * phys.k_f / phys.max_motor_thrust * 2.0 - 1.0
    return MotorOutput(
        w=w,
        thrust=fm_new[:, 0],
        moment=fm_new[:, 1:4],
        step_effort=step_effort,
        clipped_action=fm_new,
    )


def f2F(
    action: torch.Tensor,
    phys: PhysicsConfig,
    dom: DomainParams,
    randomize: bool = False,
) -> MotorOutput:
    """Direct control: normalized per-motor action (B, 4) in [-1, 1] ->
    thrust/moments, per-motor thrust ``f_i = (a_i+1) * T2WR*M*G/8``."""
    a = torch.clamp(action, -1.0, 1.0)
    f = (a + 1.0) * phys.t2wr * phys.mass * phys.gravity / 8.0
    w = torch.sqrt(f / phys.k_f)
    if randomize:
        f = f - dom.kf_degrade * f
    thrust = torch.sum(f, dim=-1)
    moment = torch.stack(
        [
            (f[:, 2] - f[:, 0]) * phys.d_arm,
            (f[:, 1] - f[:, 3]) * phys.d_arm,
            (-f[:, 0] + f[:, 1] - f[:, 2] + f[:, 3]) * phys.k_m / phys.k_f,
        ],
        dim=-1,
    )
    return MotorOutput(w=w, thrust=thrust, moment=moment, step_effort=a, clipped_action=a)


def rotor_gyro_speed(
    w: torch.Tensor, phys: PhysicsConfig, dom: DomainParams, randomize: bool = False
) -> torch.Tensor:
    """Net rotor angular momentum rate Omega_r, (B,)."""
    signs = const((-1.0, 1.0, -1.0, 1.0), w.dtype, w.device)
    if randomize:
        ir = phys.i_r * (1.0 + dom.ir_factor)
        return torch.sum(signs * w * ir, dim=-1)
    return torch.sum(signs * w, dim=-1) * phys.i_r


def drone_eq(
    x: torch.Tensor,
    thrust: torch.Tensor,
    moment: torch.Tensor,
    omega_r: torch.Tensor,
    wind: torch.Tensor,
    phys: PhysicsConfig,
    dom: DomainParams,
    randomize: bool = False,
) -> torch.Tensor:
    """Rigid-body ODE right-hand side, (B, 13) -> (B, 13).

    ``thrust``/``moment``/``omega_r`` are the resolved motor outputs
    (constant over one env step); ``wind`` (B, 3) is the inertial wind."""
    dtype, device = x.dtype, x.device
    vel = x[:, 1:6:2]
    q = quat_normalize(x[:, 6:10])
    omega = x[:, 10:13]

    rot = quat_rot_mat(q)  # body -> inertial

    # Aerodynamic drag in the body frame.
    v_body = torch.einsum("bji,bj->bi", rot, vel + wind)
    area = const(tuple(phys.area), dtype, device)
    f_drag = -0.5 * phys.rho * phys.c_d * area * torch.abs(v_body) * v_body

    # Arm rotational drag, closed form of the 10-segment sum; z doubled.
    coef = phys.rho * phys.c_d * phys.beam_thickness * (phys.d_arm / 10.0) * phys.arm_drag_sum
    m_drag = -coef * torch.abs(omega) * omega * const((1.0, 1.0, 2.0), dtype, device)

    # Gyroscopic moment from rotor momentum.
    m_gyro = torch.stack(
        [-omega[:, 0] * omega_r, omega[:, 1] * omega_r, torch.zeros_like(omega_r)], dim=-1
    )

    # Translational dynamics.
    zero = torch.zeros_like(thrust)
    f_body = torch.stack([zero, zero, thrust], dim=-1) + f_drag
    f_inertial = torch.einsum("bij,bj->bi", rot, f_body)
    quad_m = phys.mass * (1.0 + dom.mass_factor[:, None]) if randomize else phys.mass
    accel = f_inertial / quad_m - const((0.0, 0.0, phys.gravity), dtype, device)

    # Rotational dynamics. The Coriolis term uses the unperturbed J while the
    # inverse uses the randomized one, as the JAX package does.
    j_diag = const((phys.j_xx, phys.j_yy, phys.j_zz), dtype, device)
    m_in = moment + m_gyro + m_drag - torch.linalg.cross(omega, j_diag * omega, dim=-1)
    inv_j = 1.0 / (j_diag * (1.0 + dom.j_factor)) if randomize else 1.0 / j_diag
    accel_ang = inv_j * m_in

    dq = deriv_quat(omega, q)

    interleaved = torch.stack([vel, accel], dim=-1).reshape(x.shape[0], 6)
    return torch.cat([interleaved, dq, accel_ang], dim=-1)


def rk4(deriv, x: torch.Tensor, dt: float, substeps: int = 1) -> torch.Tensor:
    """Classic fixed-step RK4 over ``substeps`` equal sub-intervals."""
    h = dt / substeps
    for _ in range(substeps):
        k1 = deriv(x)
        k2 = deriv(x + 0.5 * h * k1)
        k3 = deriv(x + 0.5 * h * k2)
        k4 = deriv(x + h * k3)
        x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


class StepAux(NamedTuple):
    """Per-step diagnostics at the post-step state."""

    accel: torch.Tensor               # (B, 3) inertial acceleration
    accelerometer_read: torch.Tensor  # (B, 3) body-frame accelerometer model
    mat_rot: torch.Tensor             # (B, 3, 3) body->inertial rotation
    v_q: torch.Tensor                 # (B, 4) quaternion derivative
    f_in_z: torch.Tensor              # (B,)   commanded body-z thrust
    motor: MotorOutput


def _motor(action, phys, dom, direct_control, clipped, randomize) -> MotorOutput:
    if direct_control:
        return f2F(action, phys, dom, randomize)
    return f2w(action[:, 0], action[:, 1:4], phys, dom, clipped, randomize)


def aux_at_state(
    x: torch.Tensor,
    action: torch.Tensor,
    phys: PhysicsConfig,
    dom: DomainParams,
    *,
    wind: torch.Tensor | None = None,
    direct_control: bool = True,
    clipped: bool = True,
    randomize: bool = False,
) -> StepAux:
    """Diagnostics at the current state under ``action``, from one RHS
    evaluation and no integration."""
    action = action.to(x.dtype)
    if wind is None:
        wind = torch.zeros(x.shape[0], 3, dtype=x.dtype, device=x.device)
    motor = _motor(action, phys, dom, direct_control, clipped, randomize)
    omega_r = rotor_gyro_speed(motor.w, phys, dom, randomize)
    dx = drone_eq(x, motor.thrust, motor.moment, omega_r, wind, phys, dom, randomize)
    accel = dx[:, 1:6:2]
    q = quat_normalize(x[:, 6:10])
    rot = quat_rot_mat(q)
    # The reference's double-gravity accelerometer formula, kept as the JAX
    # package keeps it.
    grav = const((0.0, 0.0, -phys.gravity), x.dtype, x.device)
    accelerometer_read = torch.einsum("bji,bj->bi", rot, accel + grav)
    v_q = deriv_quat(x[:, 10:13], q)
    return StepAux(
        accel=accel,
        accelerometer_read=accelerometer_read,
        mat_rot=rot,
        v_q=v_q,
        f_in_z=motor.thrust,
        motor=motor,
    )


def physics_step(
    x: torch.Tensor,
    action: torch.Tensor,
    wind: torch.Tensor,
    phys: PhysicsConfig,
    dom: DomainParams,
    *,
    dt: float,
    substeps: int = 1,
    direct_control: bool = True,
    clipped: bool = True,
    randomize: bool = False,
    compute_accel_aux: bool = True,
) -> tuple[torch.Tensor, StepAux]:
    """One physics step for a batch: resolve motors, integrate with RK4,
    renormalize the quaternion. Returns the new (B, 13) state and the
    post-step diagnostics; ``compute_accel_aux=False`` skips the extra RHS
    evaluation that only sensor models read (accel aux are then zeros)."""
    action = action.to(x.dtype)
    motor = _motor(action, phys, dom, direct_control, clipped, randomize)
    omega_r = rotor_gyro_speed(motor.w, phys, dom, randomize)

    def deriv(s):
        return drone_eq(s, motor.thrust, motor.moment, omega_r, wind, phys, dom, randomize)

    x_new = rk4(deriv, x, dt, substeps)
    x_new = torch.cat(
        [x_new[:, 0:6], quat_normalize(x_new[:, 6:10]), x_new[:, 10:13]], dim=-1
    )

    rot = quat_rot_mat(x_new[:, 6:10])
    if compute_accel_aux:
        accel = deriv(x_new)[:, 1:6:2]
        grav = const((0.0, 0.0, -phys.gravity), x.dtype, x.device)
        accelerometer_read = torch.einsum("bji,bj->bi", rot, accel + grav)
    else:
        accel = torch.zeros_like(x_new[:, 0:3])
        accelerometer_read = torch.zeros_like(x_new[:, 0:3])
    v_q = deriv_quat(x_new[:, 10:13], quat_normalize(x_new[:, 6:10]))
    aux = StepAux(
        accel=accel,
        accelerometer_read=accelerometer_read,
        mat_rot=rot,
        v_q=v_q,
        f_in_z=motor.thrust,
        motor=motor,
    )
    return x_new, aux
