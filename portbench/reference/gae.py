"""Generalized advantage estimation as a reverse loop over time, then the
advantages normalized over the whole batch."""

from __future__ import annotations

import torch


@torch.no_grad()
def gae(rewards, values, dones, bootstrap, gamma: float, lam: float):
    """(returns, advantages), each (T, B), from (T, B) rewards, values and
    done flags and the (B,) values after the last step."""
    masks = 1.0 - dones.to(values.dtype)
    adv = torch.empty_like(values)
    last = torch.zeros_like(bootstrap)
    for t in reversed(range(values.shape[0])):
        nxt = bootstrap if t + 1 == values.shape[0] else values[t + 1]
        delta = rewards[t] + gamma * nxt * masks[t] - values[t]
        last = delta + gamma * lam * masks[t] * last
        adv[t] = last
    returns = adv + values
    return returns, (adv - adv.mean()) / (adv.std(correction=0) + 1e-10)
