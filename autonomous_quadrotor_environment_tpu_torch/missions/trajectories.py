"""Reference trajectory generation for mission tracking.

Counterpart of `missions/trajectories.py` in the JAX package (the
reference's `mission` class, mission_control/mission_control.py:3-83), as
precomputed position/velocity tables indexed on the device:

  * the tables are built in float64 numpy by the JAX package's closed forms
    and stored as float32 tensors, as the JAX package stores them;
  * the stateful `get_error` cursor (reference :68-83) becomes
    ``mission_target(traj, i)``, a lookup at a step index that may be a
    device tensor (so a captured chunk of steps advances it on the card),
    with the reference's past-the-end semantics: after the table is
    exhausted the target keeps drifting by ``velocity[-1] * dt`` per step
    (the reference mutates ``trajectory[-1]`` in place each call :70-71).

The 14-dim target layout matches the reference: [x, vx, y, vy, z, vz, 0*8].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Trajectory(NamedTuple):
    positions: torch.Tensor   # (N, 3), or (E, N, 3) for a batch of E episodes
    velocities: torch.Tensor  # the same shape
    dt: float

    def to(self, device) -> "Trajectory":
        return Trajectory(self.positions.to(device), self.velocities.to(device), self.dt)


def _table(traj: np.ndarray, vel: np.ndarray, dt: float) -> Trajectory:
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return Trajectory(f32(traj), f32(vel), dt)


def stack_trajectories(trajs) -> Trajectory:
    """Tables of equal length as one batched `Trajectory` (E, N, 3)."""
    return Trajectory(torch.stack([t.positions for t in trajs]),
                      torch.stack([t.velocities for t in trajs]), trajs[0].dt)


def gen_trajectory(
    total_timesteps: int,
    steps: int,
    position: np.ndarray,
    velocity: np.ndarray | None = None,
    additive: np.ndarray | None = None,
    dt: float = 0.01,
) -> Trajectory:
    """Point-to-point linear ramp then hold (reference :7-31).

    With `velocity` given, ramps velocity linearly and integrates position
    instead (reference :26-31)."""
    init = np.zeros(14) if additive is None else np.asarray(additive, np.float64)
    traj = np.zeros((total_timesteps, 3))
    vel = np.zeros((total_timesteps, 3))
    if velocity is None:
        for i in range(3):
            traj[:steps, i] = np.linspace(init[i], position[i] + init[i], steps)
            traj[steps:, i] = position[i]
        if steps > 1:
            vel[1:steps] = np.diff(traj[:steps], axis=0) / dt
    else:
        for i in range(3):
            vel[:, i] = np.linspace(0.0, velocity[i], steps)
        traj[1:steps] = np.cumsum(vel[: steps - 1] * dt, axis=0)
        traj[steps:] = traj[steps - 1]
    return _table(traj, vel, dt)


def sin_trajectory(
    steps: int,
    circular_rate: float,
    ascent_rate: float,
    center: np.ndarray,
    axis: np.ndarray,
    dt: float = 0.01,
) -> Trajectory:
    """Sinusoidal sweep along `axis` with constant ascent (reference :33-45).

    The reference's z is built recursively as ``z[k] = z[k-1] + ascent*dt``
    where the k=0 read aliases the still-zero last row, so
    ``z[k] = (k+1)*ascent*dt``: center_z is overwritten (replicated)."""
    t = np.arange(steps) * dt
    center = np.asarray(center, np.float64)
    axis = np.asarray(axis, np.float64)
    traj = center[None, :] + np.sin(t * circular_rate)[:, None] * axis[None, :]
    traj[:, 2] = np.arange(1, steps + 1) * ascent_rate * dt
    vel = np.zeros((steps, 3))
    vel[1:] = np.diff(traj, axis=0) / dt
    return _table(traj, vel, dt)


def spiral_trajectory(
    zsteps: int,
    steps: int,
    rate: float,
    circular_rate: float,
    radius: float,
    center: np.ndarray,
    dt: float = 0.01,
) -> Trajectory:
    """Helical spiral: circle in xy, linear climb capped at `zsteps`
    (reference :48-64). Starts at `center` (the -[radius,0,0] offset)."""
    step = np.arange(steps)
    a = step * circular_rate * dt
    center = np.asarray(center, np.float64)
    x = np.cos(a) * radius - radius
    y = np.sin(a) * radius
    z = np.minimum(step, zsteps) * rate * dt
    traj = center[None, :] + np.stack([x, y, z], axis=1)
    vel = np.zeros((steps, 3))
    vel[1:] = np.diff(traj, axis=0) / dt
    return _table(traj, vel, dt)


def mission_target(traj: Trajectory, i) -> torch.Tensor:
    """The 14-dim target at step ``i`` (an int or a 0-d int64 tensor on the
    table's device; reference get_error :68-83), (14,) for one table and
    (E, 14) for a batch, including the past-the-end drift by
    ``velocity[-1]*dt`` per extra call."""
    pos_t, vel_t = traj.positions, traj.velocities
    i = torch.as_tensor(i, dtype=torch.int64, device=pos_t.device)
    n = pos_t.shape[-2]
    # index_select, not indexing: a 0-d index tensor would be read on the host.
    idx = torch.clamp(i, max=n - 1).reshape(1)
    overshoot = torch.clamp(i - (n - 1), min=0).to(pos_t.dtype)
    pos = (torch.index_select(pos_t, -2, idx).squeeze(-2)
           + vel_t[..., n - 1, :] * traj.dt * overshoot)
    vel = torch.index_select(vel_t, -2, idx).squeeze(-2)
    pv = torch.stack([pos, vel], dim=-1).flatten(-2)
    return torch.cat([pv, torch.zeros(pv.shape[:-1] + (8,), dtype=pv.dtype, device=pv.device)],
                     dim=-1)
