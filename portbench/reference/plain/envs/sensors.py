"""Simulated sensor suite: accelerometer, gyro, magnetometer, GPS, TRIAD, INS.

Counterpart of `envs/sensors.py` in the JAX package, on a batch of envs
(leading axis B). The JAX package draws inside each read from a PRNG key;
here every read takes its noise as tensors, so that a caller draws them
from a `torch.Generator` (`draw_sensor_noise`) and a parity test can hand
in the JAX package's own draws.

The fused read ``sensor_fused`` reproduces the call sequence of the
reference landing worker's ``sensor_sp`` (reference
visual_landing/rl_worker.py:164-175): one fused read calls accel once,
triad twice and gyro twice, so per fused read the biases drift a_b_accel
x1, a_b_grav x2, m_b x2 and g_b x2.

Variant differences, as in the JAX package:
  * primary accel returns the env's `accelerometer_read` plus noise; opt
    accel the body-frame true acceleration `mat_rot.T @ accel` plus noise;
  * primary triad recovers gravity by subtracting the induced acceleration
    estimated with the previous TRIAD rotation and returns R; opt triad
    observes the rotated gravity/magnet vectors with noise and returns R.T;
  * primary accel_int adds +G back after rotating to inertial; opt does not.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import PhysicsConfig, SensorConfig
from ..core.quaternion import deriv_quat, rot_mat_quat
from ..device import const

# Slots of `SensorNoise.normal` (B, N_NORMAL, 3), in the order the JAX
# package's `sensor_fused` splits its key. A triad read takes a gravity and
# a magnet normal: in the primary variant the first is its accelerometer
# read's noise, in the opt variant the noise on the observed gravity.
N_ACCEL_INT, N_ACCEL_INT_TRIAD_G, N_ACCEL_INT_TRIAD_M = 0, 1, 2
N_GYRO_INT, N_GYRO, N_GPS_P, N_GPS_V, N_TRIAD_G, N_TRIAD_M = 3, 4, 5, 6, 7, 8
N_NORMAL = 9
# Slots of `SensorNoise.uniform` (B, N_UNIFORM, 3): the opt triad's bias
# weights, U[0, 1).
U_ACCEL_INT_TRIAD_G, U_ACCEL_INT_TRIAD_M, U_TRIAD_G, U_TRIAD_M = 0, 1, 2, 3
N_UNIFORM = 4


@dataclasses.dataclass
class SensorState:
    """Bias drifts + INS dead-reckoning carry (reference sensor.reset
    :630-639 and bias_reset :600-608), batched along the first axis."""

    a_b_accel: torch.Tensor  # (B,) accumulated accelerometer bias
    a_b_grav: torch.Tensor   # (B,) accumulated gravity-read bias (opt triad)
    g_b: torch.Tensor        # (B,) accumulated gyro bias
    m_b: torch.Tensor        # (B,) accumulated magnetometer bias (opt triad)
    a_b_d: torch.Tensor      # (B,) accel bias drift rate, U(-d, d)
    g_b_d: torch.Tensor      # (B,) gyro bias drift rate
    m_b_d: torch.Tensor      # (B,) magnetometer bias drift rate
    pos_ins: torch.Tensor    # (B, 3) dead-reckoned position
    vel_ins: torch.Tensor    # (B, 3) dead-reckoned velocity
    quat_ins: torch.Tensor   # (B, 4) dead-reckoned attitude
    r_est: torch.Tensor      # (B, 3, 3) previous TRIAD rotation (primary)

    def replace(self, **changes) -> "SensorState":
        return dataclasses.replace(self, **changes)


class QuadReads(NamedTuple):
    """The true quantities the sensors observe."""

    pos: torch.Tensor                 # (B, 3)
    vel: torch.Tensor                 # (B, 3)
    quat: torch.Tensor                # (B, 4)
    omega: torch.Tensor               # (B, 3) body rates
    accel: torch.Tensor               # (B, 3) inertial acceleration
    accelerometer_read: torch.Tensor  # (B, 3) primary-env accelerometer model
    mat_rot: torch.Tensor             # (B, 3, 3) body->inertial rotation
    f_in_z: torch.Tensor              # (B,) body-z thrust


class FusedOut(NamedTuple):
    """Everything `sensor_sp` produces (reference rl_worker.py:164-175)."""

    states_sens: torch.Tensor      # (B, 14) [pos/vel interleaved, quat, quat_dot]
    pos_accel: torch.Tensor        # (B, 3) INS position
    velocity_accel: torch.Tensor   # (B, 3) INS velocity
    quaternion_gyro: torch.Tensor  # (B, 4) gyro-integrated attitude
    ang_vel: torch.Tensor          # (B, 3) gyro read
    pos_gps: torch.Tensor          # (B, 3)
    vel_gps: torch.Tensor          # (B, 3)
    quaternion_triad: torch.Tensor  # (B, 4)


class SensorNoise(NamedTuple):
    """The draws of one fused read (slots above); any leading axes."""

    normal: torch.Tensor   # (..., B, N_NORMAL, 3) standard normals
    uniform: torch.Tensor  # (..., B, N_UNIFORM, 3) U[0, 1)


class TriadNoise(NamedTuple):
    g_uniform: torch.Tensor  # (B, 3)
    g_normal: torch.Tensor   # (B, 3)
    m_uniform: torch.Tensor  # (B, 3)
    m_normal: torch.Tensor   # (B, 3)


def draw_sensor_noise(gen: torch.Generator, shape: tuple, dtype=torch.float32) -> SensorNoise:
    """Noise for fused reads of leading shape ``shape`` (e.g. (frames, B)),
    on ``gen``'s device."""
    kw = dict(generator=gen, dtype=dtype, device=gen.device)
    return SensorNoise(
        normal=torch.randn(*shape, N_NORMAL, 3, **kw),
        uniform=torch.rand(*shape, N_UNIFORM, 3, **kw),
    )


def reads_from_env(x: torch.Tensor, aux) -> QuadReads:
    """QuadReads from a (B, 13) state and a `StepAux` (core/dynamics.py)."""
    return QuadReads(
        pos=x[:, 0:5:2],
        vel=x[:, 1:6:2],
        quat=x[:, 6:10],
        omega=x[:, 10:13],
        accel=aux.accel,
        accelerometer_read=aux.accelerometer_read,
        mat_rot=aux.mat_rot,
        f_in_z=aux.f_in_z,
    )


def sensor_reset(drift_u: torch.Tensor, reads: QuadReads, cfg: SensorConfig) -> SensorState:
    """Zero the biases, set the drift rates from ``drift_u`` (B, 3) U[0, 1)
    draws (accel, gyro, magnet), seed the INS with the true state (reference
    quadrotor_env.py:600-639)."""
    err = 1.0 if cfg.enabled else 0.0
    dtype = drift_u.dtype
    u = (drift_u - 0.5) * 2.0
    z = torch.zeros_like(drift_u[:, 0])
    b = drift_u.shape[0]
    return SensorState(
        a_b_accel=z,
        a_b_grav=z,
        g_b=z,
        m_b=z,
        a_b_d=u[:, 0] * cfg.accel_bias_drift * err,
        g_b_d=u[:, 1] * cfg.gyro_bias_drift * err,
        m_b_d=u[:, 2] * cfg.magnet_bias_drift * err,
        pos_ins=reads.pos.to(dtype),
        vel_ins=reads.vel.to(dtype),
        quat_ins=reads.quat.to(dtype),
        r_est=torch.eye(3, dtype=dtype, device=drift_u.device).expand(b, 3, 3).clone(),
    )


def _std(cfg: SensorConfig, base: float) -> float:
    return base if cfg.enabled else 0.0


def _body(mat_rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``mat_rot.T @ v`` per env: inertial (B, 3) or (3,) -> body frame."""
    if v.dim() == 1:
        return torch.einsum("bji,j->bi", mat_rot, v)
    return torch.einsum("bji,bj->bi", mat_rot, v)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def accel_read(
    s: SensorState, reads: QuadReads, noise: torch.Tensor, cfg: SensorConfig, dt: float,
    primary: bool = False,
) -> tuple[SensorState, torch.Tensor]:
    """Accelerometer (reference quadrotor_env.py:611-619 primary,
    quadrotor_env_opt.py:517-522 opt); ``noise`` (B, 3) standard normals.
    Advances the accel bias."""
    a_b = s.a_b_accel + s.a_b_d * dt
    read_error = a_b[:, None] + noise * _std(cfg, cfg.accel_std)
    body = reads.accelerometer_read if primary else _body(reads.mat_rot, reads.accel)
    return s.replace(a_b_accel=a_b), body + read_error


def gyro_read(
    s: SensorState, reads: QuadReads, noise: torch.Tensor, cfg: SensorConfig, dt: float
) -> tuple[SensorState, torch.Tensor]:
    """Rate gyro (reference quadrotor_env.py:622-628). Advances gyro bias."""
    g_b = s.g_b + s.g_b_d * dt
    read_error = g_b[:, None] + noise * _std(cfg, cfg.gyro_std)
    return s.replace(g_b=g_b), reads.omega + read_error


def gps_read(
    reads: QuadReads, noise_p: torch.Tensor, noise_v: torch.Tensor, cfg: SensorConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """GPS position/velocity (reference quadrotor_env.py:642-647)."""
    pos = reads.pos + noise_p * _std(cfg, cfg.gps_std_p)
    vel = reads.vel + noise_v * _std(cfg, cfg.gps_std_v)
    return pos, vel


def _triad_from_body(gravity_body, magnet_body, gravity_vec, magnet_vec):
    """Shared TRIAD construction (reference quadrotor_env.py:670-693): the
    body triad's vectors as the *columns* of tb, and tb @ ti.T."""
    t1b = _unit(gravity_body)
    t2b = _unit(torch.linalg.cross(gravity_body, magnet_body, dim=-1))
    t3b = _unit(torch.linalg.cross(t1b, t2b, dim=-1))
    tb = torch.stack([t1b, t2b, t3b], dim=-1)  # (B, 3, 3)
    t1i = _unit(gravity_vec)
    t2i = _unit(torch.linalg.cross(gravity_vec, magnet_vec, dim=-1))
    t3i = _unit(torch.linalg.cross(t1i, t2i, dim=-1))
    ti = torch.stack([t1i, t2i, t3i], dim=-1)  # (3, 3)
    return torch.einsum("bik,jk->bij", tb, ti)


def triad_read(
    s: SensorState,
    reads: QuadReads,
    noise: TriadNoise,
    cfg: SensorConfig,
    phys: PhysicsConfig,
    dt: float,
    primary: bool = False,
) -> tuple[SensorState, torch.Tensor, torch.Tensor]:
    """TRIAD attitude from gravity + magnetic observations.

    Primary (reference quadrotor_env.py:649-697): gravity is the
    accelerometer read minus the induced acceleration estimated with the
    previous TRIAD rotation; returns (q, R) and carries R. Opt
    (quadrotor_env_opt.py:552-596): noisy observation of the rotated
    gravity/magnet; returns (q, R.T) and advances a_b_grav and m_b."""
    dtype, device = s.a_b_grav.dtype, s.a_b_grav.device
    gravity_vec = const((0.0, 0.0, -phys.gravity), dtype, device)
    magnet_vec = const(tuple(cfg.magnet_vec), dtype, device)

    if primary:
        s, accel_body = accel_read(s, reads, noise.g_normal, cfg, dt, primary=True)
        zero = torch.zeros_like(reads.f_in_z)
        f_in = torch.stack([zero, zero, reads.f_in_z], dim=-1)
        induced = f_in / phys.mass - torch.einsum("bij,j->bi", s.r_est, gravity_vec)
        gravity_body = _unit(accel_body - induced)
        magnet_obs = magnet_vec + noise.m_normal * _std(cfg, cfg.magnet_std)
        magnet_body = _unit(_body(reads.mat_rot, magnet_obs))
        r = _triad_from_body(gravity_body, magnet_body, gravity_vec, magnet_vec)
        q = rot_mat_quat(r.transpose(-1, -2))
        return s.replace(r_est=r), q, r
    a_b_grav = s.a_b_grav + s.a_b_d * dt
    m_b = s.m_b + s.m_b_d * dt
    g_noise = noise.g_uniform * a_b_grav[:, None] + noise.g_normal * _std(cfg, cfg.accel_std)
    m_noise = noise.m_uniform * m_b[:, None] + noise.m_normal * _std(cfg, cfg.magnet_std)
    gravity_body = _body(reads.mat_rot, gravity_vec) + g_noise
    magnet_body = _body(reads.mat_rot, magnet_vec) + m_noise
    r = _triad_from_body(gravity_body, magnet_body, gravity_vec, magnet_vec)
    q = rot_mat_quat(r.transpose(-1, -2))
    return s.replace(a_b_grav=a_b_grav, m_b=m_b), q, r.transpose(-1, -2)


def accel_int(
    s: SensorState,
    reads: QuadReads,
    accel_noise: torch.Tensor,
    triad_noise: TriadNoise,
    cfg: SensorConfig,
    phys: PhysicsConfig,
    dt: float,
    primary: bool = False,
) -> tuple[SensorState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dead-reckoning INS update (reference quadrotor_env.py:700-715 primary,
    quadrotor_env_opt.py:598-608 opt): Euler-integrate the TRIAD-rotated
    accelerometer into velocity and position."""
    s, accel_body = accel_read(s, reads, accel_noise, cfg, dt, primary=primary)
    s, _q, r = triad_read(s, reads, triad_noise, cfg, phys, dt, primary=primary)
    if primary:
        up = const((0.0, 0.0, phys.gravity), accel_body.dtype, accel_body.device)
        acceleration = torch.einsum("bji,bj->bi", r, accel_body) + up
    else:
        acceleration = torch.einsum("bij,bj->bi", r, accel_body)
    velocity = s.vel_ins + acceleration * dt
    position = s.pos_ins + velocity * dt
    s = s.replace(vel_ins=velocity, pos_ins=position)
    return s, acceleration, velocity, position


def gyro_int(
    s: SensorState, reads: QuadReads, noise: torch.Tensor, cfg: SensorConfig, dt: float
) -> tuple[SensorState, torch.Tensor]:
    """Gyro attitude integration (reference quadrotor_env.py:717-724).

    Returns the *unnormalized* post-step quaternion while carrying the
    normalized one, as the reference's return value aliases the array
    before its normalization."""
    s, w = gyro_read(s, reads, noise, cfg, dt)
    q = s.quat_ins
    q_new = q + deriv_quat(w, q) * dt
    s = s.replace(quat_ins=q_new / torch.linalg.vector_norm(q_new, dim=-1, keepdim=True))
    return s, q_new


def _triad_noise(noise: SensorNoise, g_u: int, g_n: int, m_u: int, m_n: int) -> TriadNoise:
    return TriadNoise(
        g_uniform=noise.uniform[:, g_u], g_normal=noise.normal[:, g_n],
        m_uniform=noise.uniform[:, m_u], m_normal=noise.normal[:, m_n],
    )


def sensor_fused(
    s: SensorState,
    reads: QuadReads,
    noise: SensorNoise,
    cfg: SensorConfig,
    phys: PhysicsConfig,
    dt: float,
    primary: bool = False,
) -> tuple[SensorState, FusedOut]:
    """The landing worker's fusion read `sensor_sp` (reference
    visual_landing/rl_worker.py:164-175), in its call order: accel_int,
    gyro_int, gyro, deriv_quat, gps, triad. ``noise`` is one read's draws,
    normal (B, N_NORMAL, 3) and uniform (B, N_UNIFORM, 3)."""
    nn_ = noise.normal
    s, _acc, velocity_accel, pos_accel = accel_int(
        s, reads, nn_[:, N_ACCEL_INT],
        _triad_noise(noise, U_ACCEL_INT_TRIAD_G, N_ACCEL_INT_TRIAD_G,
                     U_ACCEL_INT_TRIAD_M, N_ACCEL_INT_TRIAD_M),
        cfg, phys, dt, primary,
    )
    s, quaternion_gyro = gyro_int(s, reads, nn_[:, N_GYRO_INT], cfg, dt)
    s, ang_vel = gyro_read(s, reads, nn_[:, N_GYRO], cfg, dt)
    quaternion_vel = deriv_quat(ang_vel, quaternion_gyro)
    pos_gps, vel_gps = gps_read(reads, nn_[:, N_GPS_P], nn_[:, N_GPS_V], cfg)
    s, quaternion_triad, _r = triad_read(
        s, reads, _triad_noise(noise, U_TRIAD_G, N_TRIAD_G, U_TRIAD_M, N_TRIAD_M),
        cfg, phys, dt, primary,
    )
    pos_vel = torch.stack([pos_accel, velocity_accel], dim=-1).reshape(-1, 6)
    states_sens = torch.cat([pos_vel, quaternion_gyro, quaternion_vel], dim=-1)
    return s, FusedOut(
        states_sens=states_sens,
        pos_accel=pos_accel,
        velocity_accel=velocity_accel,
        quaternion_gyro=quaternion_gyro,
        ang_vel=ang_vel,
        pos_gps=pos_gps,
        vel_gps=vel_gps,
        quaternion_triad=quaternion_triad,
    )
