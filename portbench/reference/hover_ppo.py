"""Plain reference of the hover controller's PPO train step.

It follows the configuration's arithmetic step by step, eagerly and in
plain PyTorch: the 75 -> N -> N -> {4, 1} tanh actor-critic as a function of
its 12 leaves, the rollout through the frozen plain hover env
(`plain.envs.hover`) with either a reset pool or a fresh episode every step,
GAE as a reverse loop over time, the clipped-surrogate loss, autograd, and
Adam written out. It draws its randomness from a generator seeded as the
program's, in the order the configuration's step draws it, so both sides see
the same noise, fresh episodes and minibatches.

The readings are what the comparison reads: each step's loss (the mean of
its minibatch losses), the first minibatch gradient per leaf and the rows
it was taken on, each leaf's change over the steps, and the envs' physics
states after the first. `first_grad` takes the gradient on given rows, to
judge another side's first gradient on that side's own rows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .adam import Adam
from .gae import gae
from .plain.config import EnvConfig
from .plain.envs import hover
from .precision import tf32


def actor_critic(leaves: list, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean (B, 4), value (B,)) of the tanh actor-critic with leaves
    [aW1, ab1, aW2, ab2, aW3, ab3, cW1, cb1, cW2, cb2, cW3, cb3], weights
    (out, in)."""
    a1, ab1, a2, ab2, a3, ab3, c1, cb1, c2, cb2, c3, cb3 = leaves
    h = torch.tanh(F.linear(obs, a1, ab1))
    h = torch.tanh(F.linear(h, a2, ab2))
    mean = torch.tanh(F.linear(h, a3, ab3))
    g = torch.tanh(F.linear(obs, c1, cb1))
    g = torch.tanh(F.linear(g, c2, cb2))
    return mean, F.linear(g, c3, cb3)[..., 0]


def log_prob(mean, action, log_std: float) -> torch.Tensor:
    """Per-dimension Gaussian log-probability."""
    z = (action - mean) / math.exp(log_std)
    return -0.5 * z * z - log_std - 0.5 * math.log(2.0 * math.pi)


@torch.no_grad()
def rollout(leaves, states, gen, env_cfg: EnvConfig, steps: int, pool: int, noise_tb4: bool,
            action_std: float):
    """``steps`` transitions from every env. The noise is drawn first, as
    (T, 4, B) when ``noise_tb4`` else (T, B, 4); then the fresh episodes:
    ``pool`` x B of them when ``pool`` > 0 (env b's k-th finished episode is
    replaced by entry (k mod pool) * B + b), else T x B, one per env and
    step."""
    b = states.x.shape[0]
    dev = states.x.device
    if noise_tb4:
        noise = torch.randn(steps, 4, b, generator=gen, device=dev).transpose(1, 2)
    else:
        noise = torch.randn(steps, b, 4, generator=gen, device=dev)
    fresh = hover.reset(gen, env_cfg, n=(pool if pool > 0 else steps) * b)
    env_idx = torch.arange(b, device=dev)
    slot = torch.zeros(b, dtype=torch.long, device=dev)
    log_std = math.log(action_std)
    cols = []
    for t in range(steps):
        obs = states.hist
        mean, value = actor_critic(leaves, obs)
        action = mean + action_std * noise[t]
        lp = log_prob(mean, action, log_std)
        stepped, out = hover.step(states, action, env_cfg)
        if pool > 0:
            picked = hover.take_envs(fresh, (slot % pool) * b + env_idx)
            slot = slot + out.done.long()
        else:
            picked = hover.take_envs(fresh, slice(t * b, (t + 1) * b))
        states = hover.where_done(out.done, picked, stepped)
        cols.append((obs, action, lp, value, out.reward, out.done))
    _, bootstrap = actor_critic(leaves, states.hist)
    obs, actions, lps, values, rewards, dones = (torch.stack(c) for c in zip(*cols))
    return states, (obs, actions, lps, values, rewards, dones), bootstrap


def ppo_loss(leaves, obs, actions, old_lp_sum, returns, advs, ppo: dict) -> torch.Tensor:
    log_std = math.log(ppo["action_std"])
    mean, value = actor_critic(leaves, obs)
    ratio = torch.exp(log_prob(mean, actions, log_std).sum(-1) - old_lp_sum)
    clipped = torch.clamp(ratio, 1.0 - ppo["clip_eps"], 1.0 + ppo["clip_eps"])
    actor_loss = -torch.minimum(ratio * advs, clipped * advs)
    critic_loss = 0.5 * torch.mean((value - returns) ** 2)
    entropy = 4.0 * (0.5 + 0.5 * math.log(2.0 * math.pi) + log_std)
    return actor_loss.mean() + critic_loss - ppo["entropy_coef"] * entropy


def minibatches(gen, steps: int, b: int, ppo: dict, tile: int):
    """Each epoch's minibatches as row indices into the (T x B) rows, T
    major: a full batch takes every row and draws nothing; otherwise a
    permutation of the blocks of ``tile`` envs at one step is drawn and cut
    into minibatches."""
    n = steps * b
    mb = min(ppo["minibatch_size"], n) if ppo["minibatch_size"] > 0 else n
    n_mb = max(n // mb, 1)
    if n_mb == 1 and mb >= n:
        return [[None]] * ppo["k_epochs"]
    per_t = b // tile
    offs = torch.arange(tile, device=gen.device)
    out = []
    for _ in range(ppo["k_epochs"]):
        perm = torch.randperm(n // tile, generator=gen, device=gen.device)
        blocks = perm[: n_mb * (mb // tile)].reshape(n_mb, mb // tile)
        out.append([((blk // per_t) * b + (blk % per_t) * tile)[:, None].add(offs).reshape(-1)
                     for blk in blocks])
    return out


def train(start: dict, states, gen, env_cfg: EnvConfig, shape: dict, ppo: dict,
          n_steps: int, control: bool = False) -> dict:
    """``n_steps`` train steps from the leaves ``start`` (name -> tensor, in
    the program's parameter order) and env ``states``, every draw from
    ``gen``. With ``control`` the products run in TF32. Returns the
    readings."""
    names = list(start)
    leaves = [start[k].detach().clone().requires_grad_(True) for k in names]
    adam = Adam(leaves, ppo["lr"], ppo["adam_b1"], ppo["adam_b2"], 1e-8)
    steps, b = shape["rollout_steps"], shape["num_envs"]
    pool = shape["fused_pool"] if shape["fused_rollout"] else shape["reset_pool"]
    losses, first_grad, first_rows, state = [], None, None, None
    with tf32(control):
        for _ in range(n_steps):
            states, roll, bootstrap = rollout(leaves, states, gen, env_cfg, steps, pool,
                                              shape["fused_rollout"], ppo["action_std"])
            obs, actions, lps, values, rewards, dones = roll
            returns, advs = gae(rewards, values, dones, bootstrap, ppo["gamma"], ppo["gae_lambda"])
            flat = lambda x: x.reshape((steps * b,) + x.shape[2:])
            rows = (flat(obs), flat(actions), flat(lps).sum(-1), flat(returns), flat(advs))
            step_losses = []
            for epoch in minibatches(gen, steps, b, ppo, shape["tile"]):
                for idx in epoch:
                    batch = rows if idx is None else tuple(x[idx] for x in rows)
                    loss = ppo_loss(leaves, *batch, ppo)
                    grads = torch.autograd.grad(loss, leaves)
                    if first_grad is None:
                        first_grad = [g.detach().clone() for g in grads]
                        first_rows = tuple(x.detach().cpu() for x in batch)
                    adam.step(grads)
                    step_losses.append(loss.detach())
            losses.append(torch.stack(step_losses).mean())
            if state is None:
                state = states.x.float().cpu()
    return {
        "names": names,
        "losses": [float(x) for x in losses],
        "first_grad": [float(torch.linalg.vector_norm(g)) for g in first_grad],
        "first_grad_t": [g.cpu() for g in first_grad],
        "first_rows": first_rows,
        "change": [float(torch.linalg.vector_norm(p.detach() - start[k]))
                   for k, p in zip(names, leaves)],
        "state": state,
    }


def first_grad(start: dict, rows: tuple, ppo: dict) -> list:
    """The loss's gradient per leaf at the leaves ``start``, in float32 (no
    TF32), on ``rows`` (obs, actions, old log-probability sums, returns,
    advantages), as a minibatch of the train step takes it."""
    leaves = [start[k].detach().clone().requires_grad_(True) for k in start]
    with tf32(False), torch.enable_grad():
        loss = ppo_loss(leaves, *rows, ppo)
        return [g.detach() for g in torch.autograd.grad(loss, leaves)]
