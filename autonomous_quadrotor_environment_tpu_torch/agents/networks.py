"""Actor-critic network of the state controller.

Counterpart of `agents/networks.py:ActorCritic` in the JAX package: a tanh
MLP actor (75 -> N -> N -> 4, tanh output) and critic (75 -> N -> N -> 1),
with a fixed action standard deviation. Initialization is the JAX package's
orthogonal recipe (gain sqrt(2) hidden, 0.01 policy head, 1 value head).
With ``learn_std`` the deviation is a learned scalar ``log_std`` parameter
(JAX networks.py:83-105), kept in float32 whatever the other parameters
become. `DiagGaussian` is the factorized Normal policy head.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..device import const

# Leaf order of the flax param tree (ops/ppo_fused.py:_LEAVES in the JAX
# package): params['params'][{actor,critic}][Dense_{0,1,2}][{kernel,bias}].
LEAVES = [
    ("actor", "Dense_0", "kernel"), ("actor", "Dense_0", "bias"),
    ("actor", "Dense_1", "kernel"), ("actor", "Dense_1", "bias"),
    ("actor", "Dense_2", "kernel"), ("actor", "Dense_2", "bias"),
    ("critic", "Dense_0", "kernel"), ("critic", "Dense_0", "bias"),
    ("critic", "Dense_1", "kernel"), ("critic", "Dense_1", "bias"),
    ("critic", "Dense_2", "kernel"), ("critic", "Dense_2", "bias"),
]


def _mlp(in_dim: int, hidden: int, out_dim: int, out_scale: float, out_tanh: bool) -> nn.Sequential:
    layers = [
        nn.Linear(in_dim, hidden), nn.Tanh(),
        nn.Linear(hidden, hidden), nn.Tanh(),
        nn.Linear(hidden, out_dim),
    ]
    if out_tanh:
        layers.append(nn.Tanh())
    for layer, gain in zip(layers[0::2], (math.sqrt(2.0), math.sqrt(2.0), out_scale)):
        nn.init.orthogonal_(layer.weight, gain)
        nn.init.zeros_(layer.bias)
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    """75 -> N -> N -> 4 tanh actor + 75 -> N -> N -> 1 critic, one shared
    action std: fixed at ``action_std``, or with ``learn_std`` a float32
    ``log_std`` parameter that starts at log(action_std)."""

    def __init__(self, hidden: int = 128, obs_dim: int = 75, act_dim: int = 4,
                 action_std: float = 0.1, learn_std: bool = False):
        super().__init__()
        self.hidden = hidden
        self.action_std = action_std
        self.learn_std = learn_std
        self.actor = _mlp(obs_dim, hidden, act_dim, 0.01, out_tanh=True)
        self.critic = _mlp(obs_dim, hidden, 1, 1.0, out_tanh=False)
        if learn_std:
            self.log_std = nn.Parameter(torch.tensor(math.log(action_std), dtype=torch.float32))

    def _apply(self, fn, recurse=True):
        """`Module.to`, `.half()`, `.bfloat16()` and the like move ``log_std``
        with the rest but never change its type: a bf16 log(0.1) has an ulp
        of about 0.0156, which swallows every small Adam step (the JAX
        package's round-5 frozen-std fault)."""
        if not self.learn_std:
            return super()._apply(fn, recurse)
        log_std = self._parameters.pop("log_std")
        try:
            super()._apply(fn, recurse)
        finally:
            self._parameters["log_std"] = log_std
        log_std.data = log_std.data.to(self.actor[0].weight.device)
        return self

    def actor_mean(self, obs: torch.Tensor) -> torch.Tensor:
        """Deterministic policy output."""
        return self.actor(obs)

    def forward(self, obs: torch.Tensor):
        """obs (B, 75) -> (mean (B, 4), value (B,), log_std (float32 scalar))."""
        mean = self.actor(obs)
        value = self.critic(obs).squeeze(-1)
        if self.learn_std:
            return mean, value, self.log_std
        return mean, value, const(math.log(self.action_std), torch.float32, obs.device)

    def linears(self) -> list[nn.Linear]:
        """The six Dense layers in `LEAVES` order."""
        return [m for head in (self.actor, self.critic) for m in head if isinstance(m, nn.Linear)]

    @classmethod
    def from_flax(cls, params: dict, action_std: float = 0.1) -> "ActorCritic":
        """Build from a flax param tree of numpy arrays (`load_params`
        output), on the CPU. flax Dense kernels are (in, out);
        `nn.Linear.weight` is (out, in). A tree with a ``log_std`` leaf
        gives a model with a learned std of that value."""
        p = params["params"]
        k0 = np.asarray(p["actor"]["Dense_0"]["kernel"])
        model = cls(
            hidden=k0.shape[1], obs_dim=k0.shape[0],
            act_dim=np.asarray(p["actor"]["Dense_2"]["kernel"]).shape[1],
            action_std=action_std, learn_std="log_std" in p,
        )
        with torch.no_grad():
            for layer, (head, name) in zip(model.linears(), [l[:2] for l in LEAVES[0::2]]):
                kernel = np.asarray(p[head][name]["kernel"], np.float32)
                bias = np.asarray(p[head][name]["bias"], np.float32)
                layer.weight.copy_(torch.from_numpy(kernel.T.copy()))
                layer.bias.copy_(torch.from_numpy(bias.copy()))
            if model.learn_std:
                model.log_std.fill_(float(np.asarray(p["log_std"], np.float32)))
        return model

    @classmethod
    def from_leaves(cls, leaves: list, action_std: float = 0.1,
                    log_std=None) -> "ActorCritic":
        """Build from the 12 leaves in `LEAVES` order, kernels (out, in) and
        biases (out, 1) or (out,), on their device (a copy); a ``log_std``
        (scalar) gives a learned std of that value."""
        w1, w3 = leaves[0], leaves[4]
        model = cls(hidden=w1.shape[0], obs_dim=w1.shape[1], act_dim=w3.shape[0],
                    action_std=action_std, learn_std=log_std is not None).to(device=w1.device)
        with torch.no_grad():
            for layer, w, b in zip(model.linears(), leaves[0::2], leaves[1::2]):
                layer.weight.copy_(w)
                layer.bias.copy_(b.reshape(-1))
            if log_std is not None:
                model.log_std.copy_(torch.as_tensor(log_std, dtype=torch.float32))
        return model


def to_flax(model: ActorCritic) -> dict:
    """The inverse of `ActorCritic.from_flax`: the flax param tree of float32
    numpy arrays, kernels (in, out) and biases (out,), with the 0-d
    ``log_std`` leaf of a learned std."""
    p: dict = {}
    for layer, (head, name) in zip(model.linears(), [l[:2] for l in LEAVES[0::2]]):
        p.setdefault(head, {})[name] = {
            "kernel": layer.weight.detach().cpu().numpy().T.copy(),
            "bias": layer.bias.detach().cpu().numpy().copy(),
        }
    if model.learn_std:
        p["log_std"] = model.log_std.detach().cpu().numpy().copy()
    return {"params": p}


@dataclasses.dataclass(frozen=True)
class DiagGaussian:
    """Factorized Normal policy head (reference model.py:62, torch Normal);
    ``log_std`` stays float32 whatever the mean's type."""

    mean: torch.Tensor
    log_std: torch.Tensor

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(self.log_std)

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        """mean + std * eps with eps ~ N(0, 1) drawn from ``gen``, which must
        live on the mean's device."""
        eps = torch.randn(self.mean.shape, generator=gen, dtype=self.mean.dtype,
                          device=self.mean.device)
        return self.mean + self.std * eps

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Per-dimension log probability (summed by the caller, matching the
        reference's `logprobs.sum(axis=2)` ppo.py:190)."""
        z = (x - self.mean) / self.std
        return -0.5 * z**2 - self.log_std - 0.5 * math.log(2.0 * math.pi)

    def entropy(self) -> torch.Tensor:
        """Per-dimension entropy (reference sums it, ppo.py:198)."""
        return 0.5 + 0.5 * math.log(2.0 * math.pi) + self.log_std * torch.ones_like(self.mean)
