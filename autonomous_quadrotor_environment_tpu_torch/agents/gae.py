"""Generalized Advantage Estimation.

Counterpart of `agents/gae.py:gae_advantages` in the JAX package (reference
environment/controller/ppo.py:125-141):

    delta_i  = r_i + gamma * v_{i+1} * mask_i - v_i
    gae_i    = delta_i + gamma * lambda * mask_i * gae_{i+1}
    return_i = gae_i + v_i
    adv      = (return - v) normalized by mean / std (+1e-10)

with ``mask_i = 1 - done_i`` and ``v_T`` the bootstrap value. The std is the
population std (ddof=0), as `jnp.std` computes it; `torch.std` defaults to
the sample std.

The recurrence is an affine map per step, ``x -> coef_i * x + delta_i``, so
it is evaluated, like the JAX package's `lax.associative_scan`, as a
log-step doubling scan in reverse: pass d composes each step's map with the
one d steps later, so after ceil(log2 T) passes every entry holds the
composition up to the end. Each pass is 4 elementwise launches on the whole
(T, ...) tensor, so T=256 costs 8 passes, about 32 launches, against about
1,000 for a reverse loop over T.
"""

from __future__ import annotations

import torch


def gae_advantages(
    rewards: torch.Tensor,          # (T, ...) per-step rewards
    values: torch.Tensor,           # (T, ...) state values v(s_0..s_{T-1})
    dones: torch.Tensor,            # (T, ...) terminal flags
    bootstrap_value: torch.Tensor,  # (...,)  v(s_T)
    gamma: float = 0.99,
    lam: float = 0.99,
    normalize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(returns, advantages)``, each shaped like ``rewards``; the
    scan runs over the leading time axis and broadcasts over the rest."""
    masks = 1.0 - dones.to(values.dtype)
    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    delta = rewards.to(values.dtype) + gamma * next_values * masks - values
    coef = gamma * lam * masks

    # (a_i, b_i) is the map x -> a_i x + b_i taking gae_{i+d} to gae_i.
    # Applying the map of step i+d after that of step i:
    # a_i (a_{i+d} x + b_{i+d}) + b_i.
    a, b = coef, delta
    steps = a.shape[0]
    d = 1
    while d < steps:
        b = torch.cat([b[:-d] + a[:-d] * b[d:], b[-d:]], dim=0)
        a = torch.cat([a[:-d] * a[d:], torch.zeros_like(a[-d:])], dim=0)
        d *= 2
    returns = b + values
    advantages = b
    if normalize:
        advantages = (advantages - advantages.mean()) / (
            advantages.std(correction=0) + 1e-10
        )
    return returns, advantages
