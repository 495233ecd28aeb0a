"""Stacked multi-seed training: a whole seed study as one batched program.

Counterpart of `agents/multiseed.py` in the JAX package, which vmaps the
serial train step over a seed axis, where the reference ran one cluster job
per seed (its 30-seed velocity study, logger_analyzer.py:45-97). Here S
controllers of one width train side by side:

* `StackedActorCritic` holds their parameters stacked on a leading seed
  axis and runs every layer for all seeds as one `torch.baddbmm`;
* the env batch is the S seeds' B envs each, seed-major, through the
  batched `envs.hover` (S * B envs), and `agents.ppo.rollout_batch` rolls
  them out as one CUDA graph replay, captured once per (stacked model, S,
  B, T); the eval's `_fly` likewise;
* the update (GAE, K epochs of minibatches, the loss, autograd) runs for
  all seeds at once, with `StackedAdam`, optax's Adam per seed with a
  learning rate per seed (the counterpart of `optax.inject_hyperparams`)
  and the global-norm clip per seed.

Seed s draws from its own generator, in the serial trainer's order: the
rollout's noise and fresh episodes (and gusts), then the update's
permutations. Those draws are the only loop over the seeds, since one
generator cannot draw another's stream; the S seeds' draws are then
concatenated. So seed s's slice does what `ppo_init(s)` and the serial
`make_train_step` do: its init bit for bit, its updates to float32
rounding (the stacked products sum in another order).

The kernels are not seed-batched, so the fused flags are refused, as in
the JAX package (JAX agents/multiseed.py:117-123).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..config import EnvConfig, PPOConfig, TrainConfig
from ..device import const, resolve_device
from ..envs import hover
from ..utils import graphs
from .gae import gae_advantages
from .networks import ActorCritic
from .ppo import PPOTrainState, _fly, ppo_init, ppo_loss, rollout_batch, update_plan


class StackedActorCritic(nn.Module):
    """S `ActorCritic`s of one width as stacked parameters: the 12 Dense
    leaves in `LEAVES` order as (S, out, in) weights and (S, out) biases,
    then with a learned std the (S,) float32 ``log_std``, so that its
    parameters line up with each serial model's. Every call takes the S
    seeds' batches seed-major, flat (S * B, obs) as the env batch holds
    them, or stacked (S, B, obs)."""

    def __init__(self, models: Sequence[ActorCritic]):
        super().__init__()
        m0 = models[0]
        self.seeds, self.hidden = len(models), m0.hidden
        self.action_std, self.learn_std = m0.action_std, m0.learn_std
        self.leaves = nn.ParameterList([
            nn.Parameter(torch.stack([getattr(m.linears()[i // 2], kind).detach()
                                      for m in models]))
            for i, kind in enumerate(("weight", "bias") * 6)])
        if self.learn_std:
            self.log_std = nn.Parameter(torch.stack([m.log_std.detach() for m in models]))

    def _head(self, x: torch.Tensor, first: int, out_tanh: bool) -> torch.Tensor:
        """Three Dense layers of one head over (S, B, in), tanh between."""
        for k in range(3):
            w, b = self.leaves[2 * (first + k)], self.leaves[2 * (first + k) + 1]
            x = torch.baddbmm(b[:, None, :], x, w.transpose(1, 2))
            if k < 2 or out_tanh:
                x = torch.tanh(x)
        return x

    def _stacked(self, obs: torch.Tensor) -> torch.Tensor:
        return obs if obs.dim() == 3 else obs.reshape(self.seeds, -1, obs.shape[-1])

    def actor_mean(self, obs: torch.Tensor) -> torch.Tensor:
        """The deterministic policy, shaped as ``obs`` is ((S * B, 4) or (S, B, 4))."""
        mean = self._head(self._stacked(obs), 0, out_tanh=True)
        return mean if obs.dim() == 3 else mean.reshape(-1, mean.shape[-1])

    def forward(self, obs: torch.Tensor):
        """(mean, value, log_std) as `ActorCritic` gives them, shaped as
        ``obs`` is; a learned ``log_std`` comes per row, (S * B, 1) or (S,
        B, 1), for `DiagGaussian` to broadcast."""
        x = self._stacked(obs)
        mean = self._head(x, 0, out_tanh=True)
        value = self._head(x, 3, out_tanh=False).squeeze(-1)
        if self.learn_std:
            log_std = self.log_std[:, None, None].expand(x.shape[0], x.shape[1], 1)
        else:
            log_std = const(math.log(self.action_std), torch.float32, obs.device)
        if obs.dim() == 2:
            mean, value = mean.reshape(-1, mean.shape[-1]), value.reshape(-1)
            if self.learn_std:
                log_std = log_std.reshape(-1, 1)
        return mean, value, log_std


class StackedAdam:
    """optax's `adam` for each seed of a `StackedActorCritic`, in the
    arithmetic of `torch.optim.Adam` that the serial trainer uses (eps
    outside the square root, bias correction by the step count), with a
    learning rate per seed: ``lr`` (S,), which the caller may change
    between steps, seed by seed (`optax.inject_hyperparams`)."""

    def __init__(self, params, lr: torch.Tensor, b1: float, b2: float, eps: float = 1e-8):
        self.params = list(params)
        self.lr = lr.to(torch.float64)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: list) -> None:
        """One Adam step of every seed from its gradients ``grads`` (the
        parameters' shapes)."""
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2_sqrt = (1.0 - self.b2 ** self.count) ** 0.5
        neg_step = -(self.lr / bc1)
        for p, g, m, v in zip(self.params, grads, self.exp_avg, self.exp_avg_sq):
            m.lerp_(g, 1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (v.sqrt() / bc2_sqrt).add_(self.eps)
            p.add_(neg_step.to(p.dtype).reshape((-1,) + (1,) * (p.dim() - 1)) * m / denom)


def make_injectable_optimizer(model: StackedActorCritic, cfg: PPOConfig,
                              lrs: Optional[Sequence[float]] = None) -> StackedAdam:
    """The stacked optimizer with its learning rates in its state, one per
    seed (``cfg.lr`` for each when ``lrs`` is None), so that a learning-rate
    x seed grid trains as one program (the reference's lr_test ran a
    cluster job per cell, training_log/lr_test/csv_reader_lr.py:18-74)."""
    lr = [cfg.lr] * model.seeds if lrs is None else list(lrs)
    device = model.leaves[0].device
    return StackedAdam(model.parameters(), torch.tensor(lr, dtype=torch.float64, device=device),
                       cfg.adam_b1, cfg.adam_b2)


@dataclasses.dataclass
class MultiSeedTrainState:
    """The stacked model and optimizer (updated in place by a train step),
    the S seeds' env states side by side (S * B envs, seed-major), each
    seed's generator, and the number of updates done."""

    model: StackedActorCritic
    optimizer: StackedAdam
    env_states: hover.EnvState
    gens: list
    update_i: int = 0


def _cat(trees: list, dim: int = 0):
    """Trees of one structure with their tensors concatenated along ``dim``."""
    return graphs.rebuild(trees[0], iter([torch.cat(col, dim) for col in
                                          zip(*map(graphs.leaves, trees))]))


def multiseed_init(seeds: Sequence[int], env_cfg: EnvConfig, ppo_cfg: PPOConfig,
                   train_cfg: TrainConfig, obs_dim: int = 75,
                   lrs: Optional[Sequence[float]] = None, device=None):
    """The stacked model, optimizer and `MultiSeedTrainState` of ``seeds``:
    seed s's slice is `agents.ppo.ppo_init(s)`'s model and env batch, bit
    for bit, and its generator. ``lrs`` (one per seed) are the seeds'
    learning rates (``ppo_cfg.lr`` when None). On ``device`` (the CUDA card
    when None)."""
    if lrs is not None and len(lrs) != len(seeds):
        raise ValueError(f"{len(lrs)} lrs for {len(seeds)} seeds")
    dev = resolve_device(device)
    inits = [ppo_init(s, env_cfg, ppo_cfg, train_cfg, obs_dim, device=dev) for s in seeds]
    model = StackedActorCritic([m for m, _, _ in inits])
    opt = make_injectable_optimizer(model, ppo_cfg, lrs)
    state = MultiSeedTrainState(model=model, optimizer=opt,
                                env_states=_cat([st.env_states for _, _, st in inits]),
                                gens=[st.gen for _, _, st in inits])
    return model, opt, state


def _require_unfused(ppo_cfg: PPOConfig, train_cfg: TrainConfig) -> None:
    if train_cfg.fused_rollout or ppo_cfg.fused_update or ppo_cfg.fused_adam:
        raise ValueError(
            "multiseed training batches the plain train step over the seed axis; the "
            "kernels (fused_rollout/fused_update) are not seed-batched: build the configs "
            "with both disabled")


class StepDraws(NamedTuple):
    """One seed's draws for one train step, in the serial step's order:
    `rollout_batch`'s action noise (T, B, 4), its fresh episodes'
    `hover.ResetDraws` over (T | P) x B, its gust draws (T, B, 3) under
    randomization, then `ppo_update`'s block permutations (K, n_mb, per),
    None for a full batch."""

    noise: torch.Tensor
    fresh: hover.ResetDraws
    gust_eps: Optional[torch.Tensor]
    perms: Optional[torch.Tensor]


def draw_step(gen: torch.Generator, env_cfg: EnvConfig, ppo_cfg: PPOConfig, b: int, steps: int,
              reset_pool: int, learn_std: bool = False) -> StepDraws:
    """What the serial row-major step (`rollout_batch`, then `ppo_update`)
    draws from ``gen`` for ``b`` envs, in its order."""
    kw = dict(generator=gen, device=gen.device)
    noise = torch.randn(steps, b, 4, **kw)
    fresh = hover.reset_draws(gen, env_cfg, (reset_pool or steps) * b)
    gust = torch.randn(steps, b, 3, **kw) if env_cfg.randomization.enabled else None
    plan = update_plan(ppo_cfg, steps * b, learn_std)
    perms = None
    if not plan.full_batch:
        per = plan.mb // plan.block
        perms = torch.stack([torch.randperm(plan.n // plan.block, **kw)[: plan.n_mb * per]
                             .reshape(plan.n_mb, per) for _ in range(ppo_cfg.k_epochs)])
    return StepDraws(noise, fresh, gust, perms)


def _seed_major(x: torch.Tensor, lead: int, axis: int, b: int) -> torch.Tensor:
    """A seed's draw ``x`` with ``lead`` rows per env flattened at ``axis``
    ((..., lead * b, ...)) as (..., lead, b, ...), so that the seeds' draws
    concatenate at ``axis + 1``."""
    return x.reshape(x.shape[:axis] + (lead, b) + x.shape[axis + 1:])


def stacked_rollout(model: StackedActorCritic, env_states: hover.EnvState, draws: list,
                    env_cfg: EnvConfig, steps: int, reset_pool: int = 0):
    """`agents.ppo.rollout_batch` of all seeds at once from their
    `StepDraws`, concatenated seed-major: one CUDA graph replay on the card.
    Returns ``(new_env_states, rollout, bootstrap)`` over the S * B envs."""
    b = draws[0].noise.shape[1]
    lead = reset_pool or steps
    cat1 = lambda xs: None if xs[0] is None else torch.cat(xs, dim=1)
    fresh = _cat([graphs.tree_map(lambda x: _seed_major(x, lead, 0, b),
                                  d.fresh._replace(warmup_gust=None)) for d in draws], dim=1)
    gust = None
    if draws[0].fresh.warmup_gust is not None:
        gust = torch.cat([_seed_major(d.fresh.warmup_gust, lead, 1, b) for d in draws], dim=2)
    return rollout_batch(model, env_states, None, env_cfg, steps, reset_pool,
                         noise=cat1([d.noise for d in draws]), fresh_x0=fresh.x0,
                         fresh_dom=fresh.dom, fresh_gust=gust,
                         gust_eps=cat1([d.gust_eps for d in draws]), fresh_vel_u=fresh.vel_u)


def clip_per_seed_(grads: list, max_norm: float) -> None:
    """`agents.ppo.clip_by_global_norm_` for each seed apart: its global
    norm over its slices of every gradient."""
    norms = torch.stack([torch.linalg.vector_norm(g.reshape(g.shape[0], -1), dim=1)
                         for g in grads], dim=1)
    norm = torch.linalg.vector_norm(norms, dim=1)
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale.reshape((-1,) + (1,) * (g.dim() - 1)))


def stacked_ppo_update(model: StackedActorCritic, opt: StackedAdam, roll, bootstrap: torch.Tensor,
                       cfg: PPOConfig, perms: Optional[torch.Tensor]) -> dict:
    """`agents.ppo.ppo_update` on the autograd branch for every seed at
    once: GAE over the S * B envs, its advantages normalized per seed, each
    seed's rows flattened as the serial update flattens them (row t * B +
    e), K epochs of minibatches cut by
    each seed's block permutations ``perms`` (S, K, n_mb, per) (None for a
    full batch), each seed's `ppo_loss` on its rows, their gradients by
    one autograd pass, the clip and the Adam step per seed. Returns the (S,) metrics averaged over the
    minibatches."""
    s = model.seeds
    returns, advantages = gae_advantages(roll.rewards, roll.values, roll.dones, bootstrap,
                                         cfg.gamma, cfg.gae_lambda, normalize=False)

    def per_seed(x):  # (T, S * B, ...) -> (S, T * B, ...)
        x = x.reshape((x.shape[0], s, -1) + x.shape[2:]).transpose(0, 1)
        return x.reshape((s, -1) + x.shape[3:])

    data = [per_seed(x) for x in (roll.obs, roll.actions, roll.logprobs, returns, advantages)]
    adv = data[-1]
    data[-1] = (adv - adv.mean(1, keepdim=True)) / (adv.std(1, correction=0, keepdim=True) + 1e-10)
    plan = update_plan(cfg, data[0].shape[1], model.learn_std or cfg.learn_std)
    n, mb, block = plan.n, plan.mb, plan.block
    seed_ix = torch.arange(s, device=data[0].device)[:, None]

    def rows(x, idx):
        if plan.full_batch:
            return x
        if block > 1:
            x = x.reshape((s, n // block, block) + x.shape[2:])[seed_ix, idx]
            return x.reshape((s, mb) + x.shape[3:])
        return x[seed_ix, idx]

    params = list(model.parameters())
    losses, mets = [], []
    for epoch in range(cfg.k_epochs):
        for j in range(1 if plan.full_batch else plan.n_mb):
            idx = None if plan.full_batch else perms[:, epoch, j]
            with torch.enable_grad():
                loss, metrics = ppo_loss(model, *(rows(x, idx) for x in data), cfg)
                grads = list(torch.autograd.grad(loss.sum(), params))
            if cfg.max_grad_norm > 0:
                clip_per_seed_(grads, cfg.max_grad_norm)
            opt.step(grads)
            losses.append(loss.detach())
            mets.append({k: v.detach() for k, v in metrics.items()})
    out = {k: torch.stack([m[k] for m in mets]).mean(0) for k in mets[0]}
    out["loss"] = torch.stack(losses).mean(0)
    return out


def multiseed_step_from_draws(model: StackedActorCritic, opt: StackedAdam,
                              env_states: hover.EnvState, draws: list, env_cfg: EnvConfig,
                              ppo_cfg: PPOConfig, reset_pool: int = 0):
    """One PPO update of every seed from the seeds' `StepDraws`:
    `stacked_rollout`, `stacked_ppo_update` and the step's metrics, each an
    (S,) tensor. Returns the new env states and the metrics."""
    steps, b = draws[0].noise.shape[:2]
    new_states, roll, bootstrap = stacked_rollout(model, env_states, draws, env_cfg, steps,
                                                  reset_pool)
    perms = None if draws[0].perms is None else torch.stack([d.perms for d in draws])
    metrics = stacked_ppo_update(model, opt, roll, bootstrap, ppo_cfg, perms)
    per = lambda x: x.reshape(steps, model.seeds, b).transpose(0, 1).reshape(model.seeds, -1)
    rewards, dones, solved = per(roll.rewards), per(roll.dones), per(roll.solved)
    done_f = dones.float()
    metrics["reward_per_step"] = rewards.mean(1)
    metrics["episodes"] = done_f.sum(1)
    metrics["solved_frac"] = solved.float().sum(1) / torch.clamp(done_f.sum(1), min=1.0)
    return new_states, metrics


def make_multiseed_train_step(model: StackedActorCritic, opt: StackedAdam, env_cfg: EnvConfig,
                              ppo_cfg: PPOConfig, train_cfg: TrainConfig):
    """One PPO update of every seed, ``train_step(state) -> (state,
    metrics)``: each seed's draws from its generator (`draw_step`), then
    `multiseed_step_from_draws`; every metric an (S,) tensor. Refuses the
    fused flags."""
    _require_unfused(ppo_cfg, train_cfg)
    steps, pool = train_cfg.rollout_steps, train_cfg.reset_pool

    def train_step(state: MultiSeedTrainState):
        if state.model is not model or state.optimizer is not opt:
            raise ValueError("state.model and state.optimizer must be the model and optimizer "
                             "this train step was made for")
        b = state.env_states.x.shape[0] // model.seeds
        draws = [draw_step(g, env_cfg, ppo_cfg, b, steps, pool, model.learn_std)
                 for g in state.gens]
        env_states, metrics = multiseed_step_from_draws(model, opt, state.env_states, draws,
                                                        env_cfg, ppo_cfg, pool)
        return dataclasses.replace(state, env_states=env_states,
                                   update_i=state.update_i + 1), metrics

    return train_step


def make_multiseed_train_loop(model: StackedActorCritic, opt: StackedAdam, env_cfg: EnvConfig,
                              ppo_cfg: PPOConfig, train_cfg: TrainConfig, inner: int):
    """``inner`` sequential stacked updates; the metrics come back (inner, S)."""
    step = make_multiseed_train_step(model, opt, env_cfg, ppo_cfg, train_cfg)

    def train_loop(state: MultiSeedTrainState):
        rows = []
        for _ in range(inner):
            state, metrics = step(state)
            rows.append(metrics)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return train_loop


def make_multiseed_eval_fn(model: StackedActorCritic, env_cfg: EnvConfig, episodes: int,
                           max_steps: Optional[int] = None):
    """Each seed's deterministic evaluation, ``eval_fn(gens) -> metrics``:
    seed s resets its ``episodes`` envs from ``gens[s]`` (and under
    randomization draws its gusts from it) as `agents.ppo.make_eval_fn`
    does, and the S seeds fly as one batch (`_fly`, one CUDA graph replay
    per chunk). Returns `make_eval_fn`'s metrics, each an (S,) tensor."""
    max_steps = max_steps or env_cfg.max_steps

    def eval_fn(gens: Sequence[torch.Generator]) -> dict:
        draws = [hover.reset_draws(g, env_cfg, episodes) for g in gens]
        cat0 = lambda xs: None if xs[0] is None else _cat(xs)
        states = hover.reset(None, env_cfg, det_state=cat0([d.x0 for d in draws]),
                             dom_draws=cat0([d.dom for d in draws]),
                             warmup_gust=None if draws[0].warmup_gust is None else
                             torch.cat([d.warmup_gust for d in draws], dim=1),
                             vel_u=cat0([d.vel_u for d in draws]))
        rec = _fly(model, env_cfg, max_steps, states, list(gens), None)
        per = lambda x: x.float().reshape(len(gens), episodes).mean(1)
        return {
            "eval_reward": per(rec["reward"]),
            "eval_length": per(rec["length"]),
            "eval_solved": per(rec["solved"]),
            "eval_survived": per(rec["survived"]),
            "eval_rms_vel_late": per(rec["rms_vel"]),
            "eval_station_keeping": per(rec["station"]),
        }

    return eval_fn


def seed_slice(tree, i: int):
    """Seed i of a stacked object: of a `StackedActorCritic` its serial
    `ActorCritic` (which `to_flax` and `save_params` take), of a
    `MultiSeedTrainState` a serial `PPOTrainState` with a `torch.optim.Adam`
    that holds the seed's moments, step count and learning rate, its envs
    and its generator; of a dict or tensor of stacked metrics, entry i."""
    if isinstance(tree, StackedActorCritic):
        log_std = tree.log_std[i].detach() if tree.learn_std else None
        return ActorCritic.from_leaves([leaf[i].detach() for leaf in tree.leaves],
                                       tree.action_std, log_std=log_std)
    if isinstance(tree, MultiSeedTrainState):
        model = seed_slice(tree.model, i)
        src = tree.optimizer
        opt = torch.optim.Adam(model.parameters(), lr=float(src.lr[i]),
                               betas=(src.b1, src.b2), eps=src.eps)
        for p, m, v in zip(model.parameters(), src.exp_avg, src.exp_avg_sq):
            opt.state[p] = {"step": torch.tensor(float(src.count)),
                            "exp_avg": m[i].clone(), "exp_avg_sq": v[i].clone()}
        b = tree.env_states.x.shape[0] // tree.model.seeds
        envs = hover.take_envs(tree.env_states, slice(i * b, (i + 1) * b))
        return PPOTrainState(model=model, optimizer=opt, env_states=envs, gen=tree.gens[i],
                             update_i=tree.update_i)
    if isinstance(tree, dict):
        return {k: seed_slice(v, i) for k, v in tree.items()}
    return tree[i]
