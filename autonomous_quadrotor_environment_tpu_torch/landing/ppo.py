"""PPO trainer for the visual-landing CNN policy, and the landing benchmark's
eval.

Counterpart of `landing/ppo.py` in the JAX package (the reference's
landing PPO, visual_landing/ppo_trainer.py:28-204, and its mother/child
data collection, rl_worker.py:267-342): lr 2e-5, K=5 epochs, minibatch
1536, the clipped surrogate on the joint diagonal-Gaussian log-prob, an
action-conditioned critic regressed on GAE returns, entropy coefficient
0.01, a learned scalar std, Adam with no gradient clip.

Differences of form from the JAX package:

* The model's parameters and a `torch.optim.Adam` hold the state, and a
  train step updates both in place; `LandingTrainState` carries them with
  the env states, the current observation and the generator.
* A `torch.Generator` replaces the PRNG key. A rollout draws everything it
  needs up front (`draw_rollout`: the reset pool's episodes and their
  warm-up noise, each decision's action noise and sensor noise, and with
  ``reset_pool=0`` each decision's fresh episodes), an update its row and
  block permutations (`draw_update`). The JAX package's streams cannot be
  reproduced, so both take their draws as arguments too, which the parity
  tests use with JAX's own draws.
* On the card each decision interval replays a CUDA graph
  (`landing.env.interval`), the counterpart of the JAX package's jitted
  scan; the render kernel B5 draws each observation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..agents.gae import gae_advantages
from ..agents.ppo import make_optimizer
from ..config import PPOConfig
from ..device import resolve_device
from ..envs import hover
from ..envs.sensors import SensorNoise
from ..utils.timing import span
from .env import (
    LandingConfigs,
    LandingObs,
    LandingState,
    ResetDraws,
    _where_done,
    draw_interval,
    draw_reset,
    landing_reset,
    landing_step,
    landing_step_autoreset,
)
from .networks import LandingActorCritic


class LandingRollout(NamedTuple):
    images: torch.Tensor    # (T, B, 3, 84, 84) float32, bfloat16 or uint8
    sens: torch.Tensor      # (T, B, 75)
    actions: torch.Tensor   # (T, B, 3)
    logprobs: torch.Tensor  # (T, B) joint log-prob
    values: torch.Tensor    # (T, B)
    rewards: torch.Tensor   # (T, B)
    dones: torch.Tensor     # (T, B) bool
    solved: torch.Tensor    # (T, B) bool


@dataclasses.dataclass
class LandingTrainState:
    """The model and optimizer (updated in place by a train step), the
    batched env states and current observation, the generator every draw
    comes from, and the number of updates done."""

    model: LandingActorCritic
    optimizer: torch.optim.Optimizer
    env_states: LandingState
    obs: LandingObs
    gen: torch.Generator
    update_i: int = 0


def landing_ppo_init(
    seed: int,
    cfgs: LandingConfigs,
    ppo_cfg: PPOConfig,
    num_envs: int,
    ctrl_model: Any,
    conv_dtype: torch.dtype = torch.float32,
    conv_s2d: bool = False,
    device=None,
) -> tuple[LandingActorCritic, torch.optim.Adam, LandingTrainState]:
    """Build the model (orthogonal init from ``seed``; parameters float32,
    convolutions and heads computed in ``conv_dtype``; the space-to-depth
    first conv with ``conv_s2d``), `optax.adam`'s counterpart (lr, b1, b2,
    eps 1e-8; no clip, as the JAX package's ``tx``), and the train state
    with ``num_envs`` fresh episodes, on ``device`` (the CUDA card when
    None; ``ctrl_model`` must live there). The state's generator is seeded
    with ``seed + 1``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LandingActorCritic(action_std=ppo_cfg.action_std, conv_s2d=conv_s2d,
                                   conv_dtype=conv_dtype)
    model = model.to(dev)
    opt = make_optimizer(model, ppo_cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    env_states, obs = landing_reset(gen, cfgs, ctrl_model, num_envs)
    return model, opt, LandingTrainState(model=model, optimizer=opt, env_states=env_states,
                                         obs=obs, gen=gen)


def _dist_logprob(mean: torch.Tensor, log_std: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Joint diagonal-Gaussian log-prob (reference MultivariateNormal with
    cov = std^2 I, rl_nn_model_v2.py:216-221)."""
    z = (action - mean) / torch.exp(log_std)
    per_dim = -0.5 * z**2 - log_std - 0.5 * math.log(2.0 * math.pi)
    return torch.sum(per_dim, dim=-1)


def _dist_entropy(log_std: torch.Tensor, dim: int = 3) -> torch.Tensor:
    return dim * (0.5 + 0.5 * math.log(2.0 * math.pi) + log_std)


class RolloutDraws(NamedTuple):
    """The randomness of one `landing_rollout` over B envs and T decisions.
    The pool's row ``p * B + e`` is slot p of env e."""

    pool: Optional[ResetDraws]           # (P * B) episodes of the reset pool
    pool_noise: Optional[SensorNoise]    # their warm-up: (frames, P * B)
    action_eps: torch.Tensor             # (T, B, 3) standard normals
    noise: SensorNoise                   # (T, frames, B): each decision's frames
    reset: Optional[ResetDraws] = None   # reset_pool=0: (T, B) fresh episodes
    reset_noise: Optional[SensorNoise] = None  # and their warm-up, (T, frames, B)


def draw_rollout(gen: torch.Generator, cfgs: LandingConfigs, b: int, steps: int,
                 reset_pool: int, dtype=torch.float32) -> RolloutDraws:
    """`RolloutDraws` from ``gen``, in field order."""
    pool = pool_noise = reset = reset_noise = None
    if reset_pool > 0:
        pool = draw_reset(gen, reset_pool * b, dtype)
        pool_noise = draw_interval(gen, cfgs, reset_pool * b, dtype)
    eps = torch.randn(steps, b, 3, generator=gen, dtype=dtype, device=gen.device)
    frames = [draw_interval(gen, cfgs, b, dtype) for _ in range(steps)]
    noise = SensorNoise(*(torch.stack(x) for x in zip(*frames)))
    if reset_pool == 0:
        resets = [draw_reset(gen, b, dtype) for _ in range(steps)]
        reset = ResetDraws(*(torch.stack(x) for x in zip(*resets)))
        warm = [draw_interval(gen, cfgs, b, dtype) for _ in range(steps)]
        reset_noise = SensorNoise(*(torch.stack(x) for x in zip(*warm)))
    return RolloutDraws(pool, pool_noise, eps, noise, reset, reset_noise)


def _store_image(image_dtype):
    """How the rollout stores images: as rendered, as ``image_dtype``, or for
    uint8 as ``clip(round(x * 255))`` (pixels live in [0, 1]; landing_loss
    dequantizes after the minibatch gather)."""
    if image_dtype is None or image_dtype == torch.float32:
        return lambda x: x
    if image_dtype == torch.uint8:
        return lambda x: torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)
    return lambda x: x.to(image_dtype)


def _at(tup, t):
    """Entry ``t`` of every field of a NamedTuple of stacked tensors."""
    return type(tup)(*(x[t] for x in tup))


def reset_pool_states(cfgs: LandingConfigs, ctrl_model: Any, draws: RolloutDraws):
    """The rollout's reset pool: ``P * B`` fresh episodes in one batch."""
    return landing_reset(None, cfgs, ctrl_model, draws=draws.pool, noise=draws.pool_noise)


@torch.no_grad()
def landing_rollout(
    model: LandingActorCritic,
    env_states: LandingState,
    obs: LandingObs,
    gen: Optional[torch.Generator],
    cfgs: LandingConfigs,
    ctrl_model: Any,
    steps: int,
    reset_pool: int = 2,
    image_dtype=None,
    *,
    draws: Optional[RolloutDraws] = None,
) -> tuple[LandingState, LandingObs, LandingRollout, torch.Tensor]:
    """Collect ``steps`` decisions from every env with auto-reset (JAX
    landing/ppo.py:109-210). Fresh episodes come from a pool of
    ``reset_pool`` per env, reset at the start of the rollout: env e takes
    slot ``slot_e % reset_pool`` when its episode ends and moves its slot
    on, so on wrap-around the start geometry repeats while its sensor and
    action noise differ. ``reset_pool=0`` resets exactly at each decision
    (`landing_step_autoreset`). The per-decision critic takes the sampled
    action, the bootstrap critic the mean action; sampling and log-probs
    are float32 whatever the model computes in. Returns the new env states
    and observation, the rollout and the bootstrap values."""
    b = obs.image.shape[0]
    if draws is None:
        draws = draw_rollout(gen, cfgs, b, steps, reset_pool, obs.control_in.dtype)
    store = _store_image(image_dtype)
    device = obs.image.device
    if reset_pool > 0:
        pool_states, pool_obs = reset_pool_states(cfgs, ctrl_model, draws)
        env_idx = torch.arange(b, device=device)
        slot = torch.zeros(b, dtype=torch.long, device=device)
    log_std = model.log_std.detach()
    images = torch.empty((steps,) + tuple(obs.image.shape), dtype=image_dtype or obs.image.dtype,
                         device=device)
    rows = []
    for t in range(steps):
        mean = model.actor(obs.image, obs.control_in).float()
        action = mean + torch.exp(log_std) * draws.action_eps[t]
        logprob = _dist_logprob(mean, log_std, action)
        value = model.critic(obs.image, obs.control_in, action).float()
        noise = _at(draws.noise, t)
        if reset_pool > 0:
            stepped, out = landing_step(env_states, action, cfgs, ctrl_model, noise=noise)
            pick = (slot % reset_pool) * b + env_idx
            env_states = hover.where_done(out.done, hover.take_envs(pool_states, pick), stepped)
            next_obs = LandingObs(*(_where_done(out.done, p[pick], o)
                                    for p, o in zip(pool_obs, out.obs)))
            slot = slot + out.done.long()
        else:
            env_states, out = landing_step_autoreset(
                env_states, action, cfgs, ctrl_model, noise=noise,
                reset_draws=_at(draws.reset, t), reset_noise=_at(draws.reset_noise, t))
            next_obs = out.obs
        images[t] = store(obs.image)
        rows.append((obs.control_in, action, logprob, value, out.reward, out.done, out.solved))
        obs = next_obs
    roll = LandingRollout(images, *(torch.stack(col) for col in zip(*rows)))
    mean = model.actor(obs.image, obs.control_in)
    bootstrap = model.critic(obs.image, obs.control_in, mean).float()
    return env_states, obs, roll, bootstrap


def landing_loss(model: LandingActorCritic, images, sens, actions, old_lp, returns, advs,
                 cfg: PPOConfig) -> tuple[torch.Tensor, dict]:
    """The clipped surrogate, the critic's MSE and the entropy bonus (JAX
    landing/ppo.py:213-238). uint8 images are dequantized here, after the
    minibatch gather, into the model's compute dtype; the surrogate, ratio,
    MSE and entropy are float32."""
    if images.dtype == torch.uint8:
        images = images.to(model.conv_dtype) * (1.0 / 255.0)
    mean = model.actor(images, sens).float()
    log_std = model.log_std
    value = model.critic(images, sens, actions).float()
    logprob = _dist_logprob(mean, log_std, actions)
    ratios = torch.exp(logprob - old_lp)
    surr1 = ratios * advs
    surr2 = torch.clamp(ratios, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * advs
    actor_loss = -torch.minimum(surr1, surr2)
    critic_loss = 0.5 * torch.mean((value - returns) ** 2)
    entropy = _dist_entropy(log_std)
    loss = torch.mean(actor_loss) + critic_loss - cfg.entropy_coef * entropy
    return loss, {"actor_loss": torch.mean(actor_loss), "critic_loss": critic_loss,
                  "entropy": entropy}


class UpdatePlan(NamedTuple):
    """The minibatch geometry of a landing update (JAX landing/ppo.py:272-300)."""

    n: int                 # rows in the batch
    mb: int                # rows per minibatch
    n_mb: int              # minibatches per epoch
    block: int             # rows per shuffled block (1 = per-row shuffle)
    full_batch: bool
    reshuffle: bool        # one row permutation per update
    reshuffle_epoch: bool  # one row permutation per epoch

    @property
    def frozen(self) -> bool:
        """block == minibatch without a reshuffle: fixed minibatch
        compositions whose order alone permutes per epoch."""
        return not self.full_batch and self.block == self.mb and not (
            self.reshuffle or self.reshuffle_epoch)


def update_plan(cfg: PPOConfig, n: int) -> UpdatePlan:
    mb = cfg.minibatch_size if cfg.minibatch_size > 0 else n
    mb = min(mb, n)
    n_mb = max(n // mb, 1)
    block = max(cfg.shuffle_block, 1)
    if n % block != 0 or mb % block != 0:
        block = 1
    full_batch = n_mb == 1 and mb >= n
    return UpdatePlan(n, mb, n_mb, block, full_batch,
                      cfg.reshuffle_per_update and not full_batch,
                      cfg.reshuffle_per_epoch and not full_batch)


class UpdateDraws(NamedTuple):
    """The randomness of one landing update: each epoch's block ids
    (K, n_mb, mb // block), absent for a full batch; the row permutation
    (n,) of ``reshuffle_per_update``; each epoch's (K, n) of
    ``reshuffle_per_epoch``."""

    perms: Optional[torch.Tensor]
    update_rows: Optional[torch.Tensor] = None
    epoch_rows: Optional[torch.Tensor] = None


def draw_update(gen: torch.Generator, plan: UpdatePlan, k_epochs: int) -> UpdateDraws:
    """`UpdateDraws` from ``gen``: the update's row permutation, then per
    epoch its row permutation and its block permutation, each only where
    the plan uses it."""
    kw = dict(generator=gen, device=gen.device)
    update_rows = torch.randperm(plan.n, **kw) if plan.reshuffle else None
    perms, epoch_rows = [], []
    for _ in range(k_epochs):
        if plan.reshuffle_epoch:
            epoch_rows.append(torch.randperm(plan.n, **kw))
        if not plan.full_batch:
            per = plan.mb // plan.block
            perms.append(torch.randperm(plan.n // plan.block, **kw)[: plan.n_mb * per]
                         .reshape(plan.n_mb, per))
    return UpdateDraws(torch.stack(perms) if perms else None, update_rows,
                       torch.stack(epoch_rows) if epoch_rows else None)


def landing_update(
    model: LandingActorCritic,
    opt: torch.optim.Optimizer,
    roll: LandingRollout,
    bootstrap: torch.Tensor,
    gen: Optional[torch.Generator],
    cfg: PPOConfig,
    draws: Optional[UpdateDraws] = None,
    grad_reduce: Optional[Callable[[list], list]] = None,
) -> dict:
    """GAE, then K epochs of minibatched Adam steps on autograd gradients of
    `landing_loss`, in place on ``model`` and ``opt`` (JAX
    landing/ppo.py:258-352): per-row or block shuffles, the full-batch
    path, and the per-update and per-epoch row reshuffles. ``grad_reduce``
    (the cross-rank mean of `parallel.dp`) takes each minibatch's gradients
    before the step (JAX landing/ppo.py:342-343). Returns the metrics
    averaged over every minibatch, as 0-d tensors."""
    returns, advs = gae_advantages(roll.rewards, roll.values, roll.dones, bootstrap,
                                   cfg.gamma, cfg.gae_lambda)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    data0 = tuple(flat(x) for x in (roll.images, roll.sens, roll.actions, roll.logprobs,
                                    returns, advs))
    plan = update_plan(cfg, data0[0].shape[0])
    n, mb, block = plan.n, plan.mb, plan.block
    if draws is None:
        draws = draw_update(gen, plan, cfg.k_epochs)
    if plan.reshuffle:
        data0 = tuple(x[draws.update_rows] for x in data0)

    def take(x, idx):
        if plan.full_batch:
            return x
        if block > 1:
            return x.reshape((n // block, block) + x.shape[1:])[idx].reshape((mb,) + x.shape[1:])
        return x[idx]

    params = list(model.parameters())
    losses, mets = [], []
    for epoch in range(cfg.k_epochs):
        data = tuple(x[draws.epoch_rows[epoch]] for x in data0) if plan.reshuffle_epoch else data0
        for idx in ([None] if plan.full_batch else draws.perms[epoch]):
            with torch.enable_grad():
                loss, metrics = landing_loss(model, *(take(x, idx) for x in data), cfg)
                grads = list(torch.autograd.grad(loss, params))
            if grad_reduce is not None:
                grads = grad_reduce(grads)
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
            losses.append(loss.detach())
            mets.append({k: v.detach() for k, v in metrics.items()})
    out = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
    out["loss"] = torch.stack(losses).mean()
    return out


def make_landing_train_step(
    model: LandingActorCritic,
    opt: torch.optim.Optimizer,
    cfgs: LandingConfigs,
    ppo_cfg: PPOConfig,
    ctrl_model: Any,
    rollout_steps: int,
    reset_pool: int = 2,
    image_dtype=None,
    grad_reduce: Optional[Callable[[list], list]] = None,
    metric_reduce: Optional[Callable[[dict], dict]] = None,
):
    """The train step ``train_step(state, rollout_draws=None,
    update_draws=None) -> (state, metrics)``: a rollout, GAE and the K-epoch
    update, every draw from the state's generator unless given. The step
    takes a state that holds ``model`` and ``opt`` and updates them in
    place. Metrics are 0-d tensors: loss, actor_loss, critic_loss,
    entropy, reward_per_decision, episodes and solved_frac. At its first
    call it prints a notice when the plan is frozen-composition (JAX
    landing/ppo.py:300-315). For data parallelism ``grad_reduce`` averages
    each minibatch's gradients over the ranks and ``metric_reduce`` the
    step's metrics (JAX landing/ppo.py:246-247, :366-367). The step runs
    under the span ``landing.step``, its rollout and update under
    ``landing.rollout`` and ``landing.update`` (`utils.timing.span`)."""
    noticed = []

    def train_step(state: LandingTrainState, rollout_draws: Optional[RolloutDraws] = None,
                   update_draws: Optional[UpdateDraws] = None):
        if state.model is not model or state.optimizer is not opt:
            raise ValueError("state.model and state.optimizer must be the model and optimizer "
                             "this train step was made for")
        with span("landing.step"):
            with span("landing.rollout"):
                env_states, obs, roll, bootstrap = landing_rollout(
                    model, state.env_states, state.obs, state.gen, cfgs, ctrl_model,
                    rollout_steps, reset_pool, image_dtype, draws=rollout_draws)
            plan = update_plan(ppo_cfg, roll.rewards.numel())
            if plan.frozen and not noticed:
                noticed.append(True)
                print(f"landing PPO: shuffle_block == minibatch ({plan.mb}) -> frozen minibatch "
                      "composition (only block order permutes per epoch)", flush=True)
            with span("landing.update"):
                metrics = landing_update(model, opt, roll, bootstrap, state.gen, ppo_cfg,
                                         update_draws, grad_reduce)
            done_f = roll.dones.float()
            metrics["reward_per_decision"] = roll.rewards.mean()
            metrics["episodes"] = done_f.sum()
            metrics["solved_frac"] = roll.solved.float().sum() / torch.clamp_min(done_f.sum(), 1.0)
            if metric_reduce is not None:
                metrics = metric_reduce(metrics)
        return dataclasses.replace(state, env_states=env_states, obs=obs,
                                   update_i=state.update_i + 1), metrics

    return train_step


def make_landing_train_loop(
    model: LandingActorCritic,
    opt: torch.optim.Optimizer,
    cfgs: LandingConfigs,
    ppo_cfg: PPOConfig,
    ctrl_model: Any,
    rollout_steps: int,
    inner: int,
    reset_pool: int = 2,
    image_dtype=None,
    grad_reduce: Optional[Callable[[list], list]] = None,
    metric_reduce: Optional[Callable[[dict], dict]] = None,
):
    """``inner`` sequential train steps: ``train_loop(state) -> (state,
    metrics)`` with each metric stacked to shape (inner,), as the JAX
    package's scan returns them."""
    step = make_landing_train_step(model, opt, cfgs, ppo_cfg, ctrl_model, rollout_steps,
                                   reset_pool, image_dtype, grad_reduce, metric_reduce)

    def train_loop(state: LandingTrainState):
        rows = []
        for _ in range(inner):
            state, metrics = step(state)
            rows.append(metrics)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return train_loop


def make_landing_eval_fn(
    model, cfgs: LandingConfigs, ctrl_model, episodes: int,
    max_decisions: Optional[int] = None,
):
    """The landing benchmark (reference rl_eval_worker.py:43, :350-354) with
    the deterministic policy, as a function ``eval_fn(gen=None, *,
    draws=None, noise=None)`` of a generator, or of injected reset
    ``draws`` and sensor ``noise`` with leading axes ((1 + max_decisions) *
    task_interval, episodes): the warm-up interval's frames first, then
    each decision's.

    It runs ``total_steps // task_interval + 2`` decisions (152), as the
    JAX package's scan does, for every episode: an episode that has ended
    keeps stepping, and its rewards and solves no longer count. Returns
    0-d tensors: eval_reward, eval_solved, eval_time_s (decisions x
    task_interval x 0.01 s) and eval_finished."""
    lcfg = cfgs.landing
    max_decisions = max_decisions or (lcfg.total_steps // lcfg.task_interval + 2)
    ti = lcfg.task_interval

    @torch.no_grad()
    def eval_fn(gen: Optional[torch.Generator] = None, *, draws: Optional[ResetDraws] = None,
                noise: Optional[SensorNoise] = None) -> dict:
        frames = lambda k: None if noise is None else SensorNoise(
            noise.normal[k * ti:(k + 1) * ti], noise.uniform[k * ti:(k + 1) * ti])
        state, obs = landing_reset(gen, cfgs, ctrl_model, episodes, draws=draws, noise=frames(0))
        device = state.hist.device
        finished = torch.zeros(episodes, dtype=torch.bool, device=device)
        solved = torch.zeros_like(finished)
        reward_sum = torch.zeros(episodes, dtype=torch.float32, device=device)
        decisions = torch.zeros(episodes, dtype=torch.int32, device=device)
        for d in range(max_decisions):
            mean = model.actor(obs.image, obs.control_in).float()
            state, out = landing_step(state, mean, cfgs, ctrl_model, gen, noise=frames(d + 1))
            active = ~finished
            reward_sum = reward_sum + out.reward * active
            solved = solved | (out.solved & active)
            decisions = decisions + active.to(torch.int32)
            finished = finished | out.done
            obs = out.obs
        return {
            "eval_reward": reward_sum.mean(),
            "eval_solved": solved.float().mean(),
            "eval_time_s": (decisions.float() * ti * 0.01).mean(),
            "eval_finished": finished.float().mean(),
        }

    return eval_fn


def landing_eval(model, cfgs, ctrl_model, episodes, gen) -> dict:
    """`make_landing_eval_fn` at its default depth, as Python floats."""
    fn = make_landing_eval_fn(model, cfgs, ctrl_model, episodes)
    return {k: float(v) for k, v in fn(gen).items()}
