"""Rolling state/action history window for the neural controllers.

Counterpart of `envs/featurizer.py` in the JAX package. Per-step feature
layout (15): [action(4), vel(3), quat(4), quat_dot(4)], built from the
14-dim quat_state ``[x,vx,y,vy,z,vz,q0..q3,dq0..dq3]`` by dropping position.
"""

from __future__ import annotations

import torch

HIST_FEATS = 15


def feat_size(t: int) -> int:
    """Network input width for a T-step window (75 for T=5)."""
    return HIST_FEATS * t


def init_hist(n: int, t: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Zeroed history buffers for ``n`` envs, (n, T*15)."""
    return torch.zeros(n, feat_size(t), dtype=dtype, device=device)


def push_hist(hist: torch.Tensor, quat_state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Shift each env's window left by one step and append the newest
    features. ``hist`` (B, T*15), ``quat_state`` (B, 14), ``action`` (B, 4)."""
    feat = torch.cat([action, quat_state[:, 1:6:2], quat_state[:, 6:14]], dim=-1)
    return torch.cat([hist[:, HIST_FEATS:], feat], dim=-1)
