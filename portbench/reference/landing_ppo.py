"""Plain reference of the visual-landing CNN's PPO train step.

Eagerly and in plain PyTorch: the frozen low-level controller read from its
msgpack file, the landing task through the frozen plain env
(`plain.landing.env`: each decision's 10 frames eagerly, the plain nadir
renderer), the two-trunk CNN actor-critic as a function of its leaves
(space-to-depth first conv, convolutions and dense layers in the stated
compute dtype over float32 leaves, a learned float32 log-std), GAE as a
reverse loop, the clipped surrogate on the joint log-probability, and Adam
written out. Its randomness comes from a generator seeded as the
program's, drawn in the order of the configuration's step.

The control computes the same with every product's operands rounded to
float8 (e4m3, per-tensor scale) before the bf16 product.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .adam import Adam
from .gae import gae
from .plain.checkpoint import load_params
from .plain.envs import hover
from .plain.landing import env as lenv
from .precision import fp8_round


class Controller:
    """The frozen low-level controller's deterministic actor, read from the
    shipped flax msgpack (kernels (in, out))."""

    def __init__(self, path: str, device):
        p = load_params(path)["params"]["actor"]
        self.layers = [(torch.tensor(np.asarray(p[f"Dense_{i}"]["kernel"], np.float32),
                                     device=device),
                        torch.tensor(np.asarray(p[f"Dense_{i}"]["bias"], np.float32),
                                     device=device)) for i in range(3)]

    def actor_mean(self, x: torch.Tensor) -> torch.Tensor:
        for k, b in self.layers:
            x = torch.tanh(x @ k + b)
        return x


def space_to_depth(img: torch.Tensor, block: int = 4) -> torch.Tensor:
    """(B, C, H, W) -> (B, block^2 C, H / block, W / block), channels in
    (p1 p2 c) order."""
    b, c, h, w = img.shape
    x = img.reshape(b, c, h // block, block, w // block, block).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, block * block * c, h // block, w // block)


class CNN:
    """The landing actor-critic on a dict of leaves named as the program's
    parameters: two trunks (conv 2x2/1 on the space-to-depth image, 4x4/2,
    3x3/1, dense 6272 -> 768, tanh each), the heads, ``log_std``."""

    def __init__(self, leaves: dict, dtype: torch.dtype, fp8: bool):
        self.p, self.dtype, self.fp8 = leaves, dtype, fp8

    def _cast(self, x):
        x = x.to(self.dtype)
        return fp8_round(x) if self.fp8 else x

    def _lin(self, name, x):
        return F.linear(self._cast(x), self._cast(self.p[name + ".weight"]),
                        self.p[name + ".bias"].to(self.dtype))

    def _trunk(self, t, img):
        x = space_to_depth(img)
        for i, stride in ((0, 1), (1, 2), (2, 1)):
            w = self.p[f"{t}.conv{i}.weight"]
            x = torch.tanh(F.conv2d(self._cast(x), self._cast(w),
                                    self.p[f"{t}.conv{i}.bias"].to(self.dtype), stride))
        return torch.tanh(self._lin(f"{t}.dense", x.flatten(1)))

    def actor(self, img, sens):
        x = torch.cat([self._trunk("conv_ac", img), sens.to(self.dtype)], dim=-1)
        return torch.tanh(self._lin("actor_out", torch.tanh(self._lin("actor_fc1", x))))

    def critic(self, img, sens, action):
        x = torch.cat([self._trunk("conv_ct", img), sens.to(self.dtype), action.to(self.dtype)],
                      dim=-1)
        return self._lin("critic_out", torch.tanh(self._lin("critic_fc1", x)))[..., 0]


def joint_log_prob(mean, log_std, action):
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * math.log(2.0 * math.pi), dim=-1)


@torch.no_grad()
def rollout(cnn: CNN, states, obs, gen, cfgs, ctrl, steps: int, pool: int):
    """``steps`` decisions from every env, fresh episodes from a pool of
    ``pool`` per env reset at the start, drawn in the program's order: the
    pool's episodes and their warm-up noise, the action noise, each
    decision's sensor noise."""
    b = obs.image.shape[0]
    dev = obs.image.device
    pool_draws = lenv.draw_reset(gen, pool * b)
    pool_noise = lenv.draw_interval(gen, cfgs, pool * b)
    eps = torch.randn(steps, b, 3, generator=gen, device=dev)
    noise = [lenv.draw_interval(gen, cfgs, b) for _ in range(steps)]
    pool_states, pool_obs = lenv.landing_reset(None, cfgs, ctrl, draws=pool_draws, noise=pool_noise)
    env_idx = torch.arange(b, device=dev)
    slot = torch.zeros(b, dtype=torch.long, device=dev)
    log_std = cnn.p["log_std"]
    cols = []
    for t in range(steps):
        mean = cnn.actor(obs.image, obs.control_in).float()
        action = mean + torch.exp(log_std) * eps[t]
        lp = joint_log_prob(mean, log_std, action)
        value = cnn.critic(obs.image, obs.control_in, action).float()
        stepped, out = lenv.landing_step(states, action, cfgs, ctrl, noise=noise[t])
        pick = (slot % pool) * b + env_idx
        states = hover.where_done(out.done, hover.take_envs(pool_states, pick), stepped)
        nxt = lenv.LandingObs(*(lenv._where_done(out.done, p[pick], o)
                                for p, o in zip(pool_obs, out.obs)))
        slot = slot + out.done.long()
        cols.append((obs.image, obs.control_in, action, lp, value, out.reward, out.done))
        obs = nxt
    mean = cnn.actor(obs.image, obs.control_in)
    bootstrap = cnn.critic(obs.image, obs.control_in, mean).float()
    return states, obs, tuple(torch.stack(c) for c in zip(*cols)), bootstrap


def loss_fn(cnn: CNN, images, sens, actions, old_lp, returns, advs, ppo: dict):
    mean = cnn.actor(images, sens).float()
    value = cnn.critic(images, sens, actions).float()
    log_std = cnn.p["log_std"]
    ratio = torch.exp(joint_log_prob(mean, log_std, actions) - old_lp)
    clipped = torch.clamp(ratio, 1.0 - ppo["clip_eps"], 1.0 + ppo["clip_eps"])
    actor_loss = -torch.minimum(ratio * advs, clipped * advs)
    critic_loss = 0.5 * torch.mean((value - returns) ** 2)
    entropy = 3.0 * (0.5 + 0.5 * math.log(2.0 * math.pi) + log_std)
    return actor_loss.mean() + critic_loss - ppo["entropy_coef"] * entropy


def train(start: dict, states, obs, gen, cfgs, ctrl, shape: dict, ppo: dict, dtype,
          n_steps: int, control: bool = False) -> dict:
    """``n_steps`` landing train steps from the leaves ``start`` and the env
    ``states`` / ``obs``, every draw from ``gen``; with ``control`` the
    products' operands in float8. Returns the readings."""
    names = list(start)
    leaves = {k: start[k].detach().clone().requires_grad_(True) for k in names}
    cnn = CNN(leaves, dtype, control)
    params = [leaves[k] for k in names]
    adam = Adam(params, ppo["lr"], ppo["adam_b1"], ppo["adam_b2"], 1e-8)
    losses, first_grad, first_rows, state = [], None, None, None
    steps, b, mb = shape["rollout_steps"], shape["num_envs"], ppo["minibatch_size"]
    for _ in range(n_steps):
        states, obs, roll, bootstrap = rollout(cnn, states, obs, gen, cfgs, ctrl, steps,
                                               shape["reset_pool"])
        images, sens, actions, lps, values, rewards, dones = roll
        returns, advs = gae(rewards, values, dones, bootstrap, ppo["gamma"], ppo["gae_lambda"])
        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        rows = tuple(flat(x) for x in (images, sens, actions, lps, returns, advs))
        n = rows[0].shape[0]
        n_mb = n // mb
        perms = [torch.randperm(n, generator=gen, device=gen.device)[: n_mb * mb]
                 .reshape(n_mb, mb) for _ in range(ppo["k_epochs"])]
        step_losses = []
        for epoch in perms:
            for idx in epoch:
                batch = tuple(x[idx] for x in rows)
                with torch.enable_grad():
                    loss = loss_fn(cnn, *batch, ppo)
                    grads = torch.autograd.grad(loss, params)
                if first_grad is None:
                    first_grad = [g.detach().clone() for g in grads]
                    first_rows = tuple(x.detach().cpu() for x in batch)
                adam.step(grads)
                step_losses.append(loss.detach())
        losses.append(torch.stack(step_losses).mean())
        if state is None:
            state = states.env.x.float().cpu()
        del images, rows, roll
    return {
        "names": names,
        "losses": [float(x) for x in losses],
        "first_grad": [float(torch.linalg.vector_norm(g.float())) for g in first_grad],
        "first_grad_t": [g.float().cpu() for g in first_grad],
        "first_rows": first_rows,
        "change": [float(torch.linalg.vector_norm(leaves[k].detach() - start[k]))
                   for k in names],
        "state": state,
    }


def first_grad(start: dict, rows: tuple, ppo: dict, dtype) -> list:
    """The loss's gradient per leaf at the leaves ``start``, the products in
    ``dtype`` over float32 leaves, on ``rows`` (images, sensors, actions,
    old log-probabilities, returns, advantages), as a minibatch of the
    update takes it; uint8 images are dequantized as the program does."""
    images, *rest = rows
    if images.dtype == torch.uint8:
        images = images.to(dtype) * (1.0 / 255.0)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in start.items()}
    with torch.enable_grad():
        loss = loss_fn(CNN(leaves, dtype, False), images, *rest, ppo)
        return [g.detach().float() for g in torch.autograd.grad(loss, list(leaves.values()))]
