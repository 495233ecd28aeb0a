"""PPO trainer for the state controller.

Counterpart of `agents/ppo.py` in the JAX package. Its `make_train_step`
takes one of two branches, by the JAX package's own gates:

* the fully fused branch (`use_fused_t`: both fused flags on and an env
  tile that `update_t_tile` admits): the whole-rollout kernel
  (`ops.rollout_fused`), GAE, and the K-epoch minibatched update through
  the transposed PPO gradient kernel (`ops.ppo_fused_t`), every batch array
  in the rollout kernel's (T, features, B) orientation;
* the row-major branch, at every other configuration (the trainer's
  defaults among them): `rollout_batch` (per-step auto-reset or a reset
  pool) or, where the rollout kernel is eligible, `rollout_batch_fused`;
  then `ppo_update`, GAE inside, whose minibatch gradients come from
  autograd of `ppo_loss`, or with ``fused_update`` from the row-major
  kernel `ops.ppo_fused.fused_ppo_grad`, or with ``fused_adam`` from
  `fused_ppo_grad_adam`, which takes the Adam step inside the kernel.

Differences of form from the JAX package:

* The model's parameters (`nn.Linear` layers, and ``log_std`` with a
  learned std) and a `torch.optim.Adam` hold the state; a train step
  updates both in place. `PPOTrainState` carries them with the env states.
* A `torch.Generator` replaces the PRNG key. A fully fused step draws, in
  order, the action noise and the reset pool (`fused_inputs`), then one
  block permutation per epoch; a row-major step draws its rollout's noise
  and fresh episodes (`rollout_batch`), or the fused rollout's inputs, then
  the permutations. The JAX package's streams cannot be reproduced, so
  each piece also takes its randomness as an argument
  (`train_step_from_inputs`, `rowmajor_step_from_inputs`, ``perms``),
  which the parity tests use.
* Domain randomization runs on the row-major branch, as in the JAX
  package: the rollout kernel refuses it (`rollout_fused.supports`), so a
  robust config rolls out through `rollout_batch`, whose fresh domains and
  gust draws are injectable too, and updates through autograd, B3 or B4.
* For data parallelism (`parallel.dp`) a step takes a gradient reduce
  (each minibatch's gradients averaged over the ranks before the clip and
  the Adam step, which keeps the Adam step out of B4), a metric reduce,
  and the envs one rank rolls out, which the kernels' gates read.
* bf16 products are refused with the ROADMAP item that will port them, and
  on the card so are shapes that the JAX package sends to a kernel the
  port's kernels do not take yet (hidden widths other than 128, B2 tiles
  that are not a multiple of 32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import EnvConfig, PPOConfig, TrainConfig
from ..core.randomization import DomainDraws
from ..device import resolve_device
from ..envs import hover
from ..ops import ppo_fused as pfr
from ..ops import rollout_fused as rf
from ..ops.ppo_fused_t import TILE_STEP, fused_ppo_grad_t
from ..utils import graphs
from .gae import gae_advantages
from .networks import ActorCritic, DiagGaussian


# A cross-rank reduce of a minibatch's gradients (a list of tensors in
# parameter order) and of a step's metrics (a dict of 0-d tensors).
GradReduce = Callable[[list], list]
MetricReduce = Callable[[dict], dict]


class Rollout(NamedTuple):
    """On-policy experience, time-major (T, B, ...)."""

    obs: torch.Tensor       # (T, B, obs_dim)
    actions: torch.Tensor   # (T, B, 4)
    logprobs: torch.Tensor  # (T, B, 4) per-dimension
    values: torch.Tensor    # (T, B)
    rewards: torch.Tensor   # (T, B)
    dones: torch.Tensor     # (T, B)
    solved: torch.Tensor    # (T, B)


@dataclasses.dataclass
class PPOTrainState:
    """The model and optimizer (updated in place by a train step), the
    batched env states, the generator every draw comes from, and the number
    of updates done."""

    model: ActorCritic
    optimizer: torch.optim.Optimizer
    env_states: hover.EnvState
    gen: torch.Generator
    update_i: int = 0


def make_optimizer(model: ActorCritic, cfg: PPOConfig) -> torch.optim.Adam:
    """`optax.adam(lr, b1, b2)` (eps 1e-8 outside the sqrt, bias correction
    by the incremented step count) over every parameter of the model, the
    learned ``log_std`` included. Gradient clipping, when
    ``cfg.max_grad_norm > 0``, is `clip_by_global_norm_`, applied by
    `ppo_update` and `ppo_update_t` before each step."""
    return torch.optim.Adam(
        model.parameters(), lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8
    )


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax's `clip_by_global_norm`, in place: scale every gradient by
    ``max_norm / max(norm, max_norm)``, norm over all of them together. (Not
    `torch.nn.utils.clip_grad_norm_`, which scales by
    ``max_norm / (norm + 1e-6)``.)"""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale)


def stream(seed: int, *tags: int) -> int:
    """A 64-bit generator seed for the stream ``tags`` of run ``seed``: the
    JAX package's `fold_in` of the run key, as a seed."""
    return int(np.random.SeedSequence([seed, *tags]).generate_state(1, np.uint64)[0])


def ppo_init(
    seed: int,
    env_cfg: EnvConfig,
    ppo_cfg: PPOConfig,
    train_cfg: TrainConfig,
    obs_dim: int = 75,
    device=None,
) -> tuple[ActorCritic, torch.optim.Adam, PPOTrainState]:
    """Build the model (orthogonal init from ``seed``; a learned float32
    ``log_std`` with ``ppo_cfg.learn_std``), the optimizer, and the train
    state with a batch of freshly reset envs, on ``device`` (the CUDA card
    when None). The state's generator lives on that device, seeded with
    ``seed + 1`` so that on the CPU its draws are not the init's."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ActorCritic(
            hidden=train_cfg.network_size, obs_dim=obs_dim, action_std=ppo_cfg.action_std,
            learn_std=ppo_cfg.learn_std,
        )
    model = model.to(dev)
    opt = make_optimizer(model, ppo_cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    env_states = hover.reset(gen, env_cfg, n=train_cfg.num_envs)
    return model, opt, PPOTrainState(
        model=model, optimizer=opt, env_states=env_states, gen=gen, update_i=0
    )


# ---------------------------------------------------------------------------
# Rollout, step by step
# ---------------------------------------------------------------------------


@torch.no_grad()
def rollout_batch(
    model: ActorCritic,
    env_states: hover.EnvState,
    gen: Optional[torch.Generator],
    env_cfg: EnvConfig,
    steps: int,
    reset_pool: int = 0,
    noise: Optional[torch.Tensor] = None,
    fresh_x0: Optional[torch.Tensor] = None,
    fresh_dom: Optional[DomainDraws] = None,
    fresh_gust: Optional[torch.Tensor] = None,
    gust_eps: Optional[torch.Tensor] = None,
    fresh_vel_u: Optional[torch.Tensor] = None,
) -> tuple[hover.EnvState, Rollout, torch.Tensor]:
    """Collect ``steps`` transitions from every env of the batch (JAX
    ppo.py:129-217): the policy acts on the env's window before the step,
    action = mean + std * eps, and a finished episode is replaced at once.

    * ``reset_pool=0``: every step is `hover.step_autoreset`, each env's
      fresh episode for step t being its own fresh reset.
    * ``reset_pool=P``: a pool of P x B fresh episodes for the whole
      rollout; env b's k-th finished episode is replaced by pool entry
      (k mod P, b), as the JAX package's per-env ``slot`` does.

    The randomness is drawn from ``gen`` in this order unless given: the
    action noise eps (T, B, 4) ~ N(0, 1), then the fresh episodes, as
    initial physical states ``fresh_x0`` ((T, B, 13) without a pool,
    (P, B, 13) with one) that `hover.reset` warms up, a velocity task's
    target draws ``fresh_vel_u`` (T | P, B, 3); under randomization also
    their domains' draws ``fresh_dom`` (a `DomainDraws` over the T x B or P x B fresh
    episodes, step or pool major) and
    their warmup steps' gust draws ``fresh_gust`` (warmup, T | P, B, 3),
    then every step's gust draw ``gust_eps`` (T, B, 3). All fresh episodes
    are reset in one batch before the first step: each is an independent
    draw from the reset distribution, so this equals resetting them step by
    step, and the step loop selects with `torch.where` and never waits on
    the host.

    Returns ``(new_env_states, rollout, bootstrap)``, the rollout
    time-major (T, B, ...), bootstrap the critic's value of the final
    windows."""
    b = env_states.x.shape[0]
    dev = env_states.x.device
    if noise is None:
        noise = torch.randn(steps, b, 4, generator=gen, device=dev)
    n_fresh = reset_pool if reset_pool > 0 else steps
    fresh = hover.reset(
        gen, env_cfg, n=n_fresh * b,
        det_state=None if fresh_x0 is None else fresh_x0.reshape(n_fresh * b, 13),
        dtype=env_states.x.dtype,
        dom_draws=None if fresh_dom is None else fresh_dom.reshape(n_fresh * b),
        warmup_gust=None if fresh_gust is None else fresh_gust.reshape(-1, n_fresh * b, 3),
        vel_u=None if fresh_vel_u is None else fresh_vel_u.reshape(n_fresh * b, 3),
    )
    if env_cfg.randomization.enabled and gust_eps is None:
        gust_eps = torch.randn(steps, b, 3, generator=gen, device=dev)
    slot = torch.zeros(b, dtype=torch.long, device=dev)
    if reset_pool > 0:
        xs, consts = (noise, gust_eps), fresh
    else:
        per_step = graphs.tree_map(lambda x: x.reshape((steps, b) + x.shape[1:]), fresh)
        xs, consts = (noise, gust_eps, per_step), None
    (states, _), rows = graphs.scan(
        ("rollout_batch", id(model), env_cfg, reset_pool),
        lambda carry, i, x, pool: _rollout_step(model, env_cfg, reset_pool, carry, x, pool),
        (env_states, slot), steps, xs=xs, consts=consts, params=list(model.parameters()),
    )
    _, bootstrap, _ = model(states.hist)
    return states, Rollout(*rows), bootstrap


def _rollout_step(model: ActorCritic, env_cfg: EnvConfig, reset_pool: int, carry, x, pool):
    """One step of `rollout_batch`: the policy's sample from the step's noise,
    the env step and its replacement of finished episodes, from the fresh
    episode of the step (``x[2]``) or of the env's pool cursor ``slot``."""
    states, slot = carry
    noise_t, eps_t = x[0], x[1]
    b = noise_t.shape[0]
    obs = states.hist
    mean, value, log_std = model(obs)
    dist = DiagGaussian(mean, log_std)
    action = mean + dist.std * noise_t
    logprob = dist.log_prob(action)
    if reset_pool > 0:
        stepped, out = hover.step(states, action, env_cfg, gust_eps=eps_t)
        env_idx = torch.arange(b, device=obs.device)
        states = hover.where_done(
            out.done, hover.take_envs(pool, (slot % reset_pool) * b + env_idx), stepped
        )
        slot = slot + out.done.long()
    else:
        states, out = hover.step_autoreset(states, action, env_cfg, fresh=x[2], gust_eps=eps_t)
    return (states, slot), (obs, action, logprob, value, out.reward, out.done, out.solved)


# ---------------------------------------------------------------------------
# Rollout through the whole-rollout kernel
# ---------------------------------------------------------------------------


def fused_inputs(
    model: ActorCritic,
    env_states: hover.EnvState,
    gen: torch.Generator,
    env_cfg: EnvConfig,
    steps: int,
    pool_size: int = 4,
):
    """The kernel's inputs for one rollout: packed start states (ROWS, B),
    action noise (T, 4, B) ~ N(0, 1), a pool (P, ROWS, B) of fresh episodes
    drawn and warmed up by `hover.reset`, and the 12 transposed leaves."""
    b = env_states.x.shape[0]
    device = env_states.x.device
    noise = torch.randn(steps, 4, b, generator=gen, device=device)
    pool_states = hover.reset(gen, env_cfg, n=pool_size * b)
    pool = rf.pack_env_state(pool_states).reshape(rf.ROWS, pool_size, b).transpose(0, 1)
    s0 = rf.pack_env_state(env_states)
    return s0, noise, pool.contiguous(), rf.transpose_leaves(model)


@torch.no_grad()
def rollout_from_inputs(model: ActorCritic, env_states: hover.EnvState, noise: torch.Tensor,
                        pool: torch.Tensor, env_cfg: EnvConfig):
    """One `fused_rollout` from given noise (T, 4, B) and packed pool
    (P, ROWS, B), then the bootstrap value of the final states. Returns
    ``(new_env_states, obs_t, misc, bootstrap)`` as
    `rollout_batch_fused_raw` does."""
    s0 = rf.pack_env_state(env_states)
    s_fin, obs_t, misc = rf.fused_rollout(
        s0, noise, pool, rf.transpose_leaves(model), env_cfg, model.action_std
    )
    new_states = rf.unpack_env_state(s_fin, env_states)
    _, bootstrap, _ = model(new_states.hist)
    return new_states, obs_t, misc, bootstrap


@torch.no_grad()
def rollout_batch_fused_raw(
    model: ActorCritic,
    env_states: hover.EnvState,
    gen: torch.Generator,
    env_cfg: EnvConfig,
    steps: int,
    pool_size: int = 4,
):
    """Roll B envs T steps through `ops.rollout_fused.fused_rollout`.

    Returns ``(new_env_states, obs_t (T,75,B), misc (T,16,B), bootstrap
    (B,))`` in the kernel's transposed orientation; misc rows are
    [action(4), logprob(4), value, reward, done, solved, zeros(4)].
    Noise and the reset pool come from ``gen``, which must live on the
    envs' device. The JAX version re-keys the envs after the kernel; a
    generator replaces the per-env keys, so nothing here corresponds."""
    _, noise, pool, _ = fused_inputs(model, env_states, gen, env_cfg, steps, pool_size)
    return rollout_from_inputs(model, env_states, noise, pool, env_cfg)


def rollout_batch_fused(
    model: ActorCritic,
    env_states: hover.EnvState,
    gen: torch.Generator,
    env_cfg: EnvConfig,
    steps: int,
    pool_size: int = 4,
) -> tuple[hover.EnvState, Rollout, torch.Tensor]:
    """`rollout_batch_fused_raw` with the outputs as a time-major `Rollout`
    of (T, B, ...) views."""
    new_states, obs_t, misc, bootstrap = rollout_batch_fused_raw(
        model, env_states, gen, env_cfg, steps, pool_size
    )
    return new_states, kernel_rollout(obs_t, misc), bootstrap


def kernel_rollout(obs_t: torch.Tensor, misc: torch.Tensor) -> Rollout:
    """The rollout kernel's (T, 75, B) and (T, 16, B) outputs as a
    time-major `Rollout` of (T, B, ...) views."""
    return Rollout(
        obs=obs_t.transpose(1, 2),
        actions=misc[:, 0:4].transpose(1, 2),
        logprobs=misc[:, 4:8].transpose(1, 2),
        values=misc[:, 8],
        rewards=misc[:, 9],
        dones=misc[:, 10] > 0.5,
        solved=misc[:, 11] > 0.5,
    )


# ---------------------------------------------------------------------------
# Loss and update
# ---------------------------------------------------------------------------


def ppo_loss(
    model: ActorCritic,
    obs: torch.Tensor,            # (n, obs_dim)
    actions: torch.Tensor,        # (n, 4)
    old_logprobs: torch.Tensor,   # (n, 4) per dimension, or (n, 1) summed
    returns: torch.Tensor,        # (n,)
    advantages: torch.Tensor,     # (n,)
    cfg: PPOConfig,
) -> tuple[torch.Tensor, dict]:
    """Clipped-surrogate PPO loss (reference ppo.py:186-203), reduced over
    the rows, the last batch axis: 0-d for one model's (n, ...) rows, (S,)
    for the stacked seeds' (S, n, ...) rows (`agents.multiseed`)."""
    mean, values, log_std = model(obs)
    dist = DiagGaussian(mean, log_std)
    logprobs = dist.log_prob(actions)
    ratios = torch.exp(logprobs.sum(-1) - old_logprobs.sum(-1))
    surr1 = ratios * advantages
    surr2 = torch.clamp(ratios, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * advantages
    actor_loss = -torch.minimum(surr1, surr2)
    critic_loss = 0.5 * torch.mean((values - returns) ** 2, dim=-1)
    entropy = dist.entropy().sum(-1)
    loss = actor_loss.mean(-1) + critic_loss - cfg.entropy_coef * entropy.mean(-1)
    metrics = {
        "actor_loss": actor_loss.mean(-1),
        "critic_loss": critic_loss,
        "entropy": entropy.mean(-1),
        "ratio_max": ratios.amax(-1),
    }
    return loss, metrics


def update_t_tile(cfg: PPOConfig, steps: int, b: int) -> int:
    """Env tile of the transposed update path, 0 if ineligible: a block is
    `tile` envs at one timestep; tile must divide the env batch and the
    minibatch row count."""
    n = steps * b
    mb = min(cfg.minibatch_size, n) if cfg.minibatch_size > 0 else n
    tile = cfg.shuffle_block if cfg.shuffle_block > 1 else 512
    tile = math.gcd(tile, b)
    if tile < 8 or n % tile or mb % tile:
        return 0
    return tile


def pack_aux_t(misc: torch.Tensor, returns: torch.Tensor, advantages: torch.Tensor) -> torch.Tensor:
    """(T, 8, B) update rows: action(4), old logprob sum, return, advantage, 0."""
    old_lp_sum = misc[:, 4:8].sum(dim=1, keepdim=True)
    return torch.cat(
        [misc[:, 0:4], old_lp_sum, returns[:, None], advantages[:, None],
         torch.zeros_like(old_lp_sum)],
        dim=1,
    ).contiguous()


def ppo_update_t(
    model: ActorCritic,
    opt: torch.optim.Optimizer,
    obs_t: torch.Tensor,       # (T, 75, B)
    aux_t: torch.Tensor,       # (T, 8, B)
    gen: Optional[torch.Generator],
    cfg: PPOConfig,
    perms: Optional[torch.Tensor] = None,
    grad_reduce: Optional[GradReduce] = None,
) -> dict:
    """K-epoch minibatched PPO update on the transposed batch through
    `ops.ppo_fused_t.fused_ppo_grad_t`, in place on ``model`` and ``opt``.

    Per epoch, a permutation of the ``n // tile`` blocks from ``gen`` is cut
    into ``n_mb`` minibatches of ``mb // tile`` blocks; a full batch takes
    every block in order and draws nothing. ``perms`` (K, n_mb, mb // tile)
    replaces the drawn permutations. ``grad_reduce`` (the cross-rank mean of
    `parallel.dp`) takes each minibatch's 12 gradients before the clip and
    the Adam step, as the JAX package's pmean does (JAX ppo.py:547-549).
    Returns the metrics averaged over all minibatches, as 0-dim tensors (no
    synchronization)."""
    steps, _, b = obs_t.shape
    n = steps * b
    mb = min(cfg.minibatch_size, n) if cfg.minibatch_size > 0 else n
    n_mb = max(n // mb, 1)
    tile = update_t_tile(cfg, steps, b)
    if tile == 0:
        raise ValueError(f"no env tile divides B={b} and the minibatch; see update_t_tile")
    full_batch = n_mb == 1 and mb >= n
    device = obs_t.device
    params = [p for layer in model.linears() for p in (layer.weight, layer.bias)]
    every_block = torch.arange(n // tile, dtype=torch.int32, device=device)[None]
    losses, mets = [], []
    for epoch in range(cfg.k_epochs):
        if full_batch:
            idxs = every_block
        elif perms is not None:
            idxs = perms[epoch].to(device=device, dtype=torch.int32)
        else:
            perm = torch.randperm(n // tile, generator=gen, device=device)
            idxs = perm[: n_mb * (mb // tile)].reshape(n_mb, mb // tile).to(torch.int32)
        for blocks in idxs:
            loss, metrics, grads = fused_ppo_grad_t(
                model, obs_t, aux_t, blocks.contiguous(), tile=tile,
                action_std=cfg.action_std, clip_eps=cfg.clip_eps,
                entropy_coef=cfg.entropy_coef,
            )
            if grad_reduce is not None:
                grads = grad_reduce(grads)
            if cfg.max_grad_norm > 0:
                clip_by_global_norm_(grads, cfg.max_grad_norm)
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
            losses.append(loss)
            mets.append(metrics)
    out = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
    out["loss"] = torch.stack(losses).mean()
    return out


class UpdatePlan(NamedTuple):
    """How `ppo_update` cuts the batch and which minibatch gradient it runs,
    decided as the JAX package's `ppo_update` decides it (ppo.py:360-408)."""

    n: int            # rows of the batch
    mb: int           # rows per minibatch
    n_mb: int         # minibatches per epoch
    block: int        # shuffle block; 1 when the rows do not divide
    full_batch: bool  # every row each step: no shuffle
    branch: str       # "autograd", "fused" (kernel B3) or "fused_adam" (B4)
    tile: int         # the kernels' row block; 0 on the autograd branch


def update_plan(cfg: PPOConfig, n: int, learn_std: bool = False,
                plain_adam: bool = True, reduced: bool = False) -> UpdatePlan:
    """The JAX gates: the block falls back to 1 when it does not divide the
    rows and the minibatch; the kernels need the fixed std and block > 1,
    or a full batch, where the tile is min(n, 512); the Adam step goes into
    the kernel with ``fused_adam``, no gradient clipping, a plain Adam
    (``plain_adam``, `ops.ppo_fused.adam_takes`) and no cross-rank gradient
    reduce (``reduced``: the Adam step inside B4 would never see the
    reduced gradient, JAX ppo.py:400-404), so under data parallelism B3
    runs in its place."""
    mb = min(cfg.minibatch_size, n) if cfg.minibatch_size > 0 else n
    n_mb = max(n // mb, 1)
    block = max(cfg.shuffle_block, 1)
    if n % block or mb % block:
        block = 1
    full_batch = n_mb == 1 and mb >= n
    tile = 0
    if cfg.fused_update and not learn_std and (block > 1 or full_batch):
        tile = block if block > 1 else min(n, 512)
        if n % tile or mb % tile:
            tile = 0
    branch = "autograd"
    if tile:
        use_adam = cfg.fused_adam and cfg.max_grad_norm == 0 and plain_adam and not reduced
        branch = "fused_adam" if use_adam else "fused"
    return UpdatePlan(n, mb, n_mb, block, full_batch, branch, tile)


def ppo_update(
    model: ActorCritic,
    opt: torch.optim.Optimizer,
    roll: Rollout,
    bootstrap: torch.Tensor,
    gen: Optional[torch.Generator],
    cfg: PPOConfig,
    perms: Optional[torch.Tensor] = None,
    grad_reduce: Optional[GradReduce] = None,
) -> dict:
    """K-epoch minibatched PPO update on the row-major batch (JAX
    ppo.py:338-486), in place on ``model`` and ``opt``: GAE, then per epoch
    a permutation of the ``n // block`` row blocks from ``gen``, cut into
    ``n_mb`` minibatches of ``mb // block`` blocks (a full batch takes every
    row in order and draws nothing). ``perms`` (K, n_mb, mb // block)
    replaces the drawn permutations.

    Each minibatch's gradient comes from the branch `update_plan` picks:
    autograd of `ppo_loss` on the gathered rows, or kernel B3 on the block
    ids (the rows are never gathered), each followed by optax's global-norm
    clip when ``max_grad_norm > 0`` and ``opt.step()``; or kernel B4, which
    takes the Adam step itself. ``grad_reduce`` takes each minibatch's
    gradients before the clip and the step (JAX ppo.py:465-467), and keeps
    the update off B4. Returns the metrics averaged over all minibatches,
    as 0-dim tensors (no synchronization)."""
    returns, advantages = gae_advantages(
        roll.rewards, roll.values, roll.dones, bootstrap, cfg.gamma, cfg.gae_lambda
    )

    def flat(x):
        return x.reshape((-1,) + x.shape[2:])

    obs, actions, old_lp = flat(roll.obs), flat(roll.actions), flat(roll.logprobs)
    rets, advs = flat(returns), flat(advantages)
    plan = update_plan(cfg, obs.shape[0], model.learn_std or cfg.learn_std,
                       pfr.adam_takes(opt, model), reduced=grad_reduce is not None)
    n, mb, block, device = plan.n, plan.mb, plan.block, obs.device
    kernel_kw = dict(tile=plan.tile, action_std=cfg.action_std, clip_eps=cfg.clip_eps,
                     entropy_coef=cfg.entropy_coef)
    if plan.tile:
        obs = obs.contiguous()
        aux = pfr.pack_aux(actions, old_lp, rets, advs)
        every_block = torch.arange(n // plan.tile, dtype=torch.int32, device=device)
        params = [p for layer in model.linears() for p in (layer.weight, layer.bias)]
    else:
        params = list(model.parameters())

    def rows(x, idx):
        if plan.full_batch:
            return x
        if block > 1:
            return x.reshape((n // block, block) + x.shape[1:])[idx].reshape((mb,) + x.shape[1:])
        return x[idx]

    losses, mets = [], []
    for epoch in range(cfg.k_epochs):
        if plan.full_batch:
            idxs = [None]
        elif perms is not None:
            idxs = perms[epoch].to(device=device, dtype=torch.long)
        else:
            perm = torch.randperm(n // block, generator=gen, device=device)
            idxs = perm[: plan.n_mb * (mb // block)].reshape(plan.n_mb, mb // block)
        for idx in idxs:
            if plan.tile:
                blocks = every_block if plan.full_batch else idx.to(torch.int32).contiguous()
            if plan.branch == "fused_adam":
                loss, metrics = pfr.fused_ppo_grad_adam(model, opt, obs, aux, blocks, **kernel_kw)
            else:
                if plan.branch == "fused":
                    loss, metrics, grads = pfr.fused_ppo_grad(model, obs, aux, blocks, **kernel_kw)
                else:
                    with torch.enable_grad():
                        loss, metrics = ppo_loss(
                            model, rows(obs, idx), rows(actions, idx), rows(old_lp, idx),
                            rows(rets, idx), rows(advs, idx), cfg,
                        )
                        grads = list(torch.autograd.grad(loss, params))
                    loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
                if grad_reduce is not None:
                    grads = grad_reduce(grads)
                if cfg.max_grad_norm > 0:
                    clip_by_global_norm_(grads, cfg.max_grad_norm)
                for p, g in zip(params, grads):
                    p.grad = g
                opt.step()
            losses.append(loss)
            mets.append(metrics)
    out = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
    out["loss"] = torch.stack(losses).mean()
    return out


# ---------------------------------------------------------------------------
# Train step and loop
# ---------------------------------------------------------------------------


def _step_metrics(metrics: dict, rewards, dones, solved) -> dict:
    done_f = dones.float()
    metrics["reward_per_step"] = rewards.mean()
    metrics["episodes"] = done_f.sum()
    metrics["solved_frac"] = solved.float().sum() / torch.clamp(done_f.sum(), min=1.0)
    return metrics


def train_step_from_inputs(
    model: ActorCritic,
    opt: torch.optim.Optimizer,
    env_states: hover.EnvState,
    noise: torch.Tensor,
    pool: torch.Tensor,
    env_cfg: EnvConfig,
    ppo_cfg: PPOConfig,
    gen: Optional[torch.Generator] = None,
    perms: Optional[torch.Tensor] = None,
    grad_reduce: Optional[GradReduce] = None,
) -> tuple[hover.EnvState, dict]:
    """One fully fused train step from given rollout randomness: rollout
    kernel -> GAE -> aux packing -> `ppo_update_t` (with ``grad_reduce``).
    Returns the new env states and the step's metrics (0-dim tensors)."""
    new_states, obs_t, misc, bootstrap = rollout_from_inputs(
        model, env_states, noise, pool, env_cfg
    )
    rewards, dones, solved = misc[:, 9], misc[:, 10] > 0.5, misc[:, 11] > 0.5
    returns, advs = gae_advantages(
        rewards, misc[:, 8], dones, bootstrap, ppo_cfg.gamma, ppo_cfg.gae_lambda
    )
    aux_t = pack_aux_t(misc, returns, advs)
    metrics = ppo_update_t(model, opt, obs_t, aux_t, gen, ppo_cfg, perms, grad_reduce)
    return new_states, _step_metrics(metrics, rewards, dones, solved)


def uses_fused_rollout(env_cfg: EnvConfig, ppo_cfg: PPOConfig, train_cfg: TrainConfig) -> bool:
    """The JAX package's `use_fused_rollout` gate."""
    steps = train_cfg.rollout_steps
    return (
        train_cfg.fused_rollout
        and rf.supports(env_cfg, ppo_cfg.learn_std, env_cfg.hist_t * 15)
        and steps % min(16, steps) == 0
    )


def rowmajor_step_from_inputs(
    model: ActorCritic,
    opt: torch.optim.Optimizer,
    env_states: hover.EnvState,
    env_cfg: EnvConfig,
    ppo_cfg: PPOConfig,
    train_cfg: TrainConfig,
    gen: Optional[torch.Generator] = None,
    *,
    noise: Optional[torch.Tensor] = None,
    pool: Optional[torch.Tensor] = None,
    fresh_x0: Optional[torch.Tensor] = None,
    fresh_dom: Optional[DomainDraws] = None,
    fresh_gust: Optional[torch.Tensor] = None,
    gust_eps: Optional[torch.Tensor] = None,
    perms: Optional[torch.Tensor] = None,
    grad_reduce: Optional[GradReduce] = None,
) -> tuple[hover.EnvState, dict]:
    """One train step of the row-major branch (JAX ppo.py:649-663): the
    rollout, through the rollout kernel (`rollout_from_inputs`) where the
    JAX `use_fused_rollout` gate holds and through `rollout_batch`
    otherwise, then `ppo_update`. Each draw comes from ``gen`` unless given:
    the kernel's ``noise`` (T, 4, B) and packed ``pool`` (P, ROWS, B)
    (`fused_inputs`), or `rollout_batch`'s ``noise`` (T, B, 4),
    ``fresh_x0`` and under randomization ``fresh_dom``, ``fresh_gust`` and
    ``gust_eps``; and the update's ``perms``. ``grad_reduce`` goes to
    `ppo_update`. Returns the new env states and the step's metrics (0-dim
    tensors)."""
    if uses_fused_rollout(env_cfg, ppo_cfg, train_cfg):
        if noise is None:
            _, noise, pool, _ = fused_inputs(model, env_states, gen, env_cfg,
                                             train_cfg.rollout_steps, train_cfg.fused_pool)
        new_states, obs_t, misc, bootstrap = rollout_from_inputs(
            model, env_states, noise, pool, env_cfg
        )
        roll = kernel_rollout(obs_t, misc)
    else:
        new_states, roll, bootstrap = rollout_batch(
            model, env_states, gen, env_cfg, train_cfg.rollout_steps, train_cfg.reset_pool,
            noise=noise, fresh_x0=fresh_x0, fresh_dom=fresh_dom, fresh_gust=fresh_gust,
            gust_eps=gust_eps,
        )
    metrics = ppo_update(model, opt, roll, bootstrap, gen, ppo_cfg, perms, grad_reduce)
    return new_states, _step_metrics(metrics, roll.rewards, roll.dones, roll.solved)


def train_branch(model: ActorCritic, opt: torch.optim.Optimizer, env_cfg: EnvConfig,
                 ppo_cfg: PPOConfig, train_cfg: TrainConfig, local_envs: Optional[int] = None,
                 reduced: bool = False) -> str:
    """The branch the JAX package's `make_train_step` takes for these
    configs, "fused_t" or "rowmajor", after its consistency guards. A
    randomized env takes the row-major branch, since the rollout kernel
    refuses it (`uses_fused_rollout`), as in the JAX package. The gates
    read the batch that one rank rolls out, ``local_envs`` (all
    ``num_envs`` when None; JAX ppo.py:584-594, :623), and ``reduced`` (a
    cross-rank gradient reduce) keeps the Adam step out of B4. Refuses what
    is not ported yet: bf16 products in a kernel, and, for a model on the
    card, a shape that the JAX package sends
    to a kernel the port's kernels do not take (hidden widths other than
    128; obs widths other than 75, that is hist_t other than 5; B2 tiles
    that are not a multiple of 32). The CPU runs every shape
    through the kernels' plain versions."""
    if train_cfg.fused_rollout or ppo_cfg.fused_update:
        if float(model.action_std) != float(ppo_cfg.action_std):
            raise ValueError(
                f"model.action_std={model.action_std} != "
                f"ppo_cfg.action_std={ppo_cfg.action_std}: the fused kernels "
                "take the policy std from both places and must agree"
            )
        if bool(model.learn_std) != bool(ppo_cfg.learn_std):
            raise ValueError(
                f"model.learn_std={model.learn_std} != ppo_cfg.learn_std={ppo_cfg.learn_std}"
            )
    steps = train_cfg.rollout_steps
    b = train_cfg.num_envs if local_envs is None else local_envs
    fused_rollout = uses_fused_rollout(env_cfg, ppo_cfg, train_cfg)
    tile_t = update_t_tile(ppo_cfg, steps, b)
    fused_t = fused_rollout and ppo_cfg.fused_update and not ppo_cfg.fused_adam and tile_t > 0
    plan = update_plan(ppo_cfg, steps * b, model.learn_std or ppo_cfg.learn_std,
                       pfr.adam_takes(opt, model), reduced)
    kernel_update = fused_t or plan.branch != "autograd"
    if kernel_update and ppo_cfg.fused_compute != "f32":
        raise NotImplementedError(
            f"fused_compute={ppo_cfg.fused_compute!r} is not ported yet "
            "(ROADMAP B, the rest of B1 and B2)"
        )
    if next(model.parameters()).device.type == "cuda":
        if (fused_rollout or kernel_update) and model.hidden != rf.HIDDEN:
            raise NotImplementedError(
                f"the port's kernels take hidden width {rf.HIDDEN}, not {model.hidden} "
                "(ROADMAP B, the rest of B1 and B2)"
            )
        if kernel_update and env_cfg.hist_t * 15 != pfr.OBS:
            raise NotImplementedError(
                f"the port's update kernels take {pfr.OBS}-dim obs, not {env_cfg.hist_t * 15} "
                f"(hist_t={env_cfg.hist_t}; ROADMAP B, the rest of B1 and B2)"
            )
        if fused_t and tile_t % TILE_STEP:
            raise NotImplementedError(
                f"the port's B2 kernel takes env tiles that are multiples of {TILE_STEP}, "
                f"not {tile_t} (ROADMAP B, the rest of B1 and B2)"
            )
    return "fused_t" if fused_t else "rowmajor"


def make_train_step(
    model: ActorCritic,
    opt: torch.optim.Optimizer,
    env_cfg: EnvConfig,
    ppo_cfg: PPOConfig,
    train_cfg: TrainConfig,
    grad_reduce: Optional[GradReduce] = None,
    metric_reduce: Optional[MetricReduce] = None,
    local_envs: Optional[int] = None,
):
    """The train step, ``train_step(state) -> (state, metrics)``, on the
    branch `train_branch` picks: fully fused (`train_step_from_inputs`) or
    row-major (`rowmajor_step_from_inputs`), every draw from the state's
    generator.

    For data parallelism (`parallel.dp`), ``grad_reduce`` averages each
    minibatch's gradients over the ranks before the Adam step,
    ``metric_reduce`` the step's metrics (``episodes`` too, as the JAX
    package's pmean does), and ``local_envs`` is the envs one rank rolls
    out, which the kernels' gates read (JAX ppo.py:572-594).

    ``model`` and ``opt`` are checked against the configs here; the step
    takes a state that holds these same two objects (as `ppo_init` makes
    it) and updates them in place. Metrics are 0-dim tensors: ``loss``,
    ``actor_loss``, ``critic_loss``, ``entropy``, ``ratio_max``,
    ``reward_per_step``, ``episodes`` and ``solved_frac``."""
    branch = train_branch(model, opt, env_cfg, ppo_cfg, train_cfg, local_envs,
                          grad_reduce is not None)

    def train_step(state: PPOTrainState) -> tuple[PPOTrainState, dict]:
        if state.model is not model or state.optimizer is not opt:
            raise ValueError(
                "state.model and state.optimizer must be the model and optimizer "
                "this train step was made for"
            )
        if branch == "fused_t":
            _, noise, pool, _ = fused_inputs(
                model, state.env_states, state.gen, env_cfg,
                train_cfg.rollout_steps, train_cfg.fused_pool,
            )
            env_states, metrics = train_step_from_inputs(
                model, opt, state.env_states, noise, pool, env_cfg, ppo_cfg, state.gen,
                grad_reduce=grad_reduce,
            )
        else:
            env_states, metrics = rowmajor_step_from_inputs(
                model, opt, state.env_states, env_cfg, ppo_cfg, train_cfg, state.gen,
                grad_reduce=grad_reduce,
            )
        if metric_reduce is not None:
            metrics = metric_reduce(metrics)
        return dataclasses.replace(
            state, env_states=env_states, update_i=state.update_i + 1
        ), metrics

    return train_step


def make_train_loop(
    model: ActorCritic,
    opt: torch.optim.Optimizer,
    env_cfg: EnvConfig,
    ppo_cfg: PPOConfig,
    train_cfg: TrainConfig,
    inner: int,
    grad_reduce: Optional[GradReduce] = None,
    metric_reduce: Optional[MetricReduce] = None,
    local_envs: Optional[int] = None,
):
    """`inner` sequential train steps: ``train_loop(state) -> (state,
    metrics)`` with each metric stacked to shape (inner,); the reduces and
    ``local_envs`` as `make_train_step` takes them."""
    step = make_train_step(model, opt, env_cfg, ppo_cfg, train_cfg, grad_reduce,
                           metric_reduce, local_envs)

    def train_loop(state: PPOTrainState) -> tuple[PPOTrainState, dict]:
        rows = []
        for _ in range(inner):
            state, metrics = step(state)
            rows.append(metrics)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return train_loop


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


FLY_CHUNK = 64  # eval steps per graph replay, between checks that every episode ended


@torch.no_grad()
def _fly(model: ActorCritic, env_cfg: EnvConfig, max_steps: int, states: hover.EnvState,
         gen, gust_eps: Optional[torch.Tensor]) -> dict:
    """Fly every env of ``states`` with the actor mean through `hover.step`
    for up to ``max_steps`` steps and return per-episode tensors: the
    records of `make_forensic_eval_fn`, of which `make_eval_fn` reports the
    means. Each step's gust draw is ``gust_eps[i]`` (max_steps, B, 3) or
    drawn from ``gen`` before the chunk of steps it falls in, with
    `hover.step`'s own call, in step order; ``gen`` may be a list of
    generators, one per equal slice of the batch (the seeds of a stacked
    study, `agents.multiseed`), each drawing its slice's. The steps run in chunks of
    FLY_CHUNK, each on the card one CUDA graph replay (`utils.graphs.scan`);
    the loop stops before a chunk once every episode has finished, which
    changes nothing: finished episodes add nothing."""
    b = states.x.shape[0]
    dev = states.x.device
    zeros = lambda dtype: torch.zeros(b, dtype=dtype, device=dev)
    f32 = torch.float32
    # finished, solved, reward, length, v2_sum, v2_n, saturated steps, peak gust
    acc = (zeros(torch.bool), zeros(torch.bool), zeros(f32), zeros(torch.int32),
           zeros(f32), zeros(f32), zeros(f32), zeros(f32))
    xs = gust_eps
    if env_cfg.randomization.enabled and gust_eps is None:
        if gen is None:
            raise ValueError("a randomized eval needs gust_eps or a generator to draw it from")

        gens = list(gen) if isinstance(gen, (list, tuple)) else [gen]

        def xs(i0, n):
            return torch.cat([torch.stack([
                torch.randn(b // len(gens), 3, generator=g, dtype=states.x.dtype, device=g.device)
                for _ in range(n)]) for g in gens], dim=1)
    (_, acc), _ = graphs.scan(
        ("fly", id(model), env_cfg, max_steps),
        lambda carry, i, eps, _: (_fly_step(model, env_cfg, max_steps // 5, carry, i, eps), None),
        (states, acc), max_steps, xs=xs, chunk=FLY_CHUNK, params=list(model.parameters()),
        stop=lambda carry: bool(carry[1][0].all()),
    )
    _, solved, reward_sum, length, v2_sum, v2_n, sat_steps, peak_gust = acc
    rms_vel = torch.sqrt(v2_sum / torch.clamp(v2_n, min=1.0))
    # The env's step counter starts at `warmup` after reset, so its timeout
    # fires after max_steps - warmup active steps (the JAX package's
    # round-5 survival cut).
    survived = solved | (length >= max_steps - env_cfg.warmup)
    station = survived & (rms_vel < 0.5)
    dom0 = states.dom
    return {
        "severity": dom0.gust_scale,
        "mass_factor": dom0.mass_factor,
        "kf_mean": dom0.kf_degrade.mean(-1),
        "peak_gust": peak_gust,
        "solved": solved,
        "survived": survived,
        "station": station,
        "rms_vel": rms_vel,
        "length": length,
        "reward": reward_sum,
        "sat_frac": sat_steps / torch.clamp(length.float(), min=1.0),
    }


def _fly_step(model: ActorCritic, env_cfg: EnvConfig, settle_steps: int, carry, i, eps):
    """One step of `_fly` at step index ``i`` (a 0-d tensor) with the gust
    draw ``eps`` (None when calm)."""
    states, (finished, solved, reward_sum, length, v2_sum, v2_n, sat_steps, peak_gust) = carry
    mean = model.actor_mean(states.hist)
    active = ~finished
    # The actor at its authority limit: the tanh head and the motor model
    # both saturate at |a| = 1.
    sat_steps = sat_steps + (torch.any(mean.abs() > 0.99, dim=-1) & active).float()
    states, out = hover.step(states, mean, env_cfg, gust_eps=eps)
    peak_gust = torch.maximum(
        peak_gust, torch.linalg.vector_norm(states.dom.gust_next, dim=-1) * active)
    reward_sum = reward_sum + out.reward * active
    solved = solved | (out.solved & active)
    length = length + active.to(torch.int32)
    late = active & (i >= settle_steps)
    vel2 = ((states.x[:, 1:6:2] - states.vel_target) ** 2).sum(-1)
    v2_sum = v2_sum + vel2 * late
    v2_n = v2_n + late.float()
    finished = finished | out.done
    return states, (finished, solved, reward_sum, length, v2_sum, v2_n, sat_steps, peak_gust)


def make_eval_fn(model: ActorCritic, env_cfg: EnvConfig, episodes: int,
                 max_steps: Optional[int] = None):
    """Deterministic evaluation: `episodes` parallel envs flown with the
    actor mean through `hover.step` (reference `evaluate` ppo.py:272-295),
    reporting mean reward, length, solved, survived, late RMS velocity and
    station-keeping fractions (survive AND hold the post-settle RMS
    velocity under 0.5 m/s: the robust criterion).

    ``eval_fn(gen=None, env_states=None, gust_eps=None)`` resets
    ``episodes`` envs from ``gen`` unless ``env_states`` are given; under
    randomization each step's gust draw is ``gust_eps[i]`` (max_steps, B,
    3) or drawn from ``gen``."""
    max_steps = max_steps or env_cfg.max_steps

    def eval_fn(gen: Optional[torch.Generator] = None,
                env_states: Optional[hover.EnvState] = None,
                gust_eps: Optional[torch.Tensor] = None) -> dict:
        states = env_states if env_states is not None else hover.reset(gen, env_cfg, n=episodes)
        rec = _fly(model, env_cfg, max_steps, states, gen, gust_eps)
        return {
            "eval_reward": rec["reward"].mean(),
            "eval_length": rec["length"].float().mean(),
            "eval_solved": rec["solved"].float().mean(),
            "eval_survived": rec["survived"].float().mean(),
            "eval_rms_vel_late": rec["rms_vel"].mean(),
            "eval_station_keeping": rec["station"].float().mean(),
        }

    return eval_fn


def make_forensic_eval_fn(model: ActorCritic, env_cfg: EnvConfig, episodes: int,
                          max_steps: Optional[int] = None):
    """Per-episode diagnostic evaluation (JAX ppo.py:789-871): the protocol
    of `make_eval_fn`, from the same draws in the same order, but one record
    per episode: its severity and domain perturbations as reset drew them,
    the peak gust target during the episode, which criteria passed (strict
    solve, survival, station-keeping), post-settle RMS velocity, length,
    reward, and the fraction of its steps with any motor command |a| >
    0.99. Takes the arguments of ``eval_fn``."""
    max_steps = max_steps or env_cfg.max_steps

    def eval_fn(gen: Optional[torch.Generator] = None,
                env_states: Optional[hover.EnvState] = None,
                gust_eps: Optional[torch.Tensor] = None) -> dict:
        states = env_states if env_states is not None else hover.reset(gen, env_cfg, n=episodes)
        return _fly(model, env_cfg, max_steps, states, gen, gust_eps)

    return eval_fn


def evaluate(model: ActorCritic, env_cfg: EnvConfig, episodes: int,
             gen: torch.Generator) -> dict:
    """One-shot evaluation, as Python floats."""
    return {k: float(v) for k, v in make_eval_fn(model, env_cfg, episodes)(gen).items()}
