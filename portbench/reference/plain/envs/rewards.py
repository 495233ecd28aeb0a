"""Shaped hover/position reward with cascading steady-state bonuses.

Counterpart of `envs/rewards.py` in the JAX package, on a batch of envs:
every per-env quantity carries a leading (B,) axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import BB_ANG, BB_VEL, RewardConfig


class RewardOut(NamedTuple):
    reward: torch.Tensor
    shaping: torch.Tensor  # new prev_shaping carry
    solved: torch.Tensor   # bool
    done: torch.Tensor     # updated done flag


def hover_reward(
    cfg: RewardConfig,
    *,
    vel: torch.Tensor,           # (B, 3) inertial velocity (error)
    ang: torch.Tensor,           # (B, 3) Euler angles [phi, theta, psi]
    ang_vel: torch.Tensor,       # (B, 3) body rates
    action: torch.Tensor,        # (B, 4) the step's action (clipped in direct mode)
    zero_control: torch.Tensor,  # (4,) neutral action
    prev_shaping: torch.Tensor,  # (B,) previous shaping value
    has_prev: torch.Tensor,      # (B,) bool: prev_shaping is valid
    step_i: torch.Tensor,        # (B,) int step counter (post-increment)
    max_steps: int,
    bb_done: torch.Tensor,       # (B,) bool: bounding box breached
    training: bool,
) -> RewardOut:
    """Compute (reward, shaping, solved, done) for one step: potential-based
    shaping difference (zero on the first step), cascading bonuses at the
    first satisfied threshold with a nested attitude gate, the absolute
    control penalty, and the terminal taxonomy (solved / timeout / box)."""
    psi = ang[:, 2]
    coefs = cfg.shaping_coefs
    shaping = -(
        coefs[0] * torch.linalg.vector_norm(vel / BB_VEL, dim=-1)
        + coefs[1] * torch.abs(psi / 4.0)
        + coefs[2] * torch.linalg.vector_norm(ang[:, 0:2] / BB_ANG, dim=-1)
    )

    r_norm = torch.sqrt(torch.sum(vel**2, dim=-1) + psi**2)
    ang_gate_vec = ang if cfg.cascade_ang_all3 else ang[:, 0:2]
    ang_norm = torch.linalg.vector_norm(ang_gate_vec, dim=-1)
    n_gate = math.sqrt(3.0) if cfg.cascade_ang_all3 else math.sqrt(2.0)
    taken = torch.zeros_like(bb_done)
    bonus = torch.zeros_like(shaping)
    for tr_i, trp_i in zip(cfg.tr, cfg.tr_p):
        hit = ~taken & (r_norm < 2.0 * tr_i)
        inner = ang_norm < n_gate * tr_i * cfg.cascade_ang_factor
        bonus = bonus + torch.where(hit, trp_i * (1.0 + inner.to(shaping.dtype)), 0.0)
        taken = taken | hit
    shaping = shaping + bonus

    reward = torch.where(has_prev, shaping - prev_shaping, torch.zeros_like(shaping))
    reward = reward - torch.sum((action - zero_control) ** 2, dim=-1) * cfg.p_c

    target = 9.0 * cfg.tr[0] ** 2
    current = (
        torch.sum(vel**2, dim=-1) + torch.sum(ang**2, dim=-1) + torch.sum(ang_vel**2, dim=-1)
    )
    solved = current < target
    timeout = step_i >= max_steps

    if cfg.terminal_replaces:
        solved_r = torch.full_like(reward, cfg.solved_reward)
        broken_r = torch.full_like(reward, cfg.broken_reward)
    else:
        solved_r = reward + cfg.solved_reward
        broken_r = reward + cfg.broken_reward
    reward = torch.where(
        solved, solved_r, torch.where(timeout, reward, torch.where(bb_done, broken_r, reward))
    )

    done = bb_done | timeout
    if training:
        done = done | solved
    return RewardOut(reward=reward, shaping=shaping, solved=solved, done=done)
