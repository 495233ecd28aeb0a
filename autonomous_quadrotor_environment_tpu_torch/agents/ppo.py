"""PPO trainer for the state controller on the fully fused path.

Counterpart of `agents/ppo.py` in the JAX package, for the branch that its
`make_train_step` takes when both fused flags are on (`use_fused_t`): the
whole-rollout kernel (`ops.rollout_fused`), GAE, and the K-epoch
minibatched update through the PPO gradient kernel (`ops.ppo_fused_t`),
every batch array in the rollout kernel's (T, features, B) orientation.

Differences of form from the JAX package:

* The model's `nn.Linear` layers hold the parameters and a
  `torch.optim.Adam` holds the optimizer state; a train step updates both
  in place. `PPOTrainState` carries them with the env states.
* A `torch.Generator` replaces the PRNG key. One step draws, in order, the
  action noise and the reset pool (`fused_inputs`), then one block
  permutation per epoch. The JAX package's streams cannot be reproduced,
  so each piece also takes its randomness as an argument
  (`train_step_from_inputs`, ``perms``), which the parity tests use.
* Configurations off the fused branch (the unfused rollout and update, a
  learned std, the Adam step inside the kernel, bf16 products) are not
  ported yet and are refused with the ROADMAP item that will port them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..config import EnvConfig, PPOConfig, TrainConfig
from ..device import resolve_device
from ..envs import hover
from ..ops import rollout_fused as rf
from ..ops.ppo_fused_t import fused_ppo_grad_t
from .gae import gae_advantages
from .networks import ActorCritic, DiagGaussian


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
    by the incremented step count). Gradient clipping, when
    ``cfg.max_grad_norm > 0``, is `clip_by_global_norm_`, applied by
    `ppo_update_t` before each step."""
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


def ppo_init(
    seed: int,
    env_cfg: EnvConfig,
    ppo_cfg: PPOConfig,
    train_cfg: TrainConfig,
    obs_dim: int = 75,
    device=None,
) -> tuple[ActorCritic, torch.optim.Adam, PPOTrainState]:
    """Build the model (orthogonal init from ``seed``), the optimizer, and
    the train state with a batch of freshly reset envs, on ``device`` (the
    CUDA card when None). The state's generator lives on that device,
    seeded with ``seed + 1`` so that on the CPU its draws are not the
    init's."""
    dev = resolve_device(device)
    if ppo_cfg.learn_std:
        raise NotImplementedError("a learned log_std is not ported yet (ROADMAP A6)")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ActorCritic(
            hidden=train_cfg.network_size, obs_dim=obs_dim, action_std=ppo_cfg.action_std
        )
    model = model.to(dev)
    opt = make_optimizer(model, ppo_cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    env_states = hover.reset(gen, env_cfg, n=train_cfg.num_envs)
    return model, opt, PPOTrainState(
        model=model, optimizer=opt, env_states=env_states, gen=gen, update_i=0
    )


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
    roll = Rollout(
        obs=obs_t.transpose(1, 2),
        actions=misc[:, 0:4].transpose(1, 2),
        logprobs=misc[:, 4:8].transpose(1, 2),
        values=misc[:, 8],
        rewards=misc[:, 9],
        dones=misc[:, 10] > 0.5,
        solved=misc[:, 11] > 0.5,
    )
    return new_states, roll, bootstrap


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
    """Clipped-surrogate PPO loss (reference ppo.py:186-203)."""
    mean, values, log_std = model(obs)
    dist = DiagGaussian(mean, log_std)
    logprobs = dist.log_prob(actions)
    ratios = torch.exp(logprobs.sum(-1) - old_logprobs.sum(-1))
    surr1 = ratios * advantages
    surr2 = torch.clamp(ratios, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * advantages
    actor_loss = -torch.minimum(surr1, surr2)
    critic_loss = 0.5 * torch.mean((values - returns) ** 2)
    entropy = dist.entropy().sum(-1)
    loss = actor_loss.mean() + critic_loss - cfg.entropy_coef * entropy.mean()
    metrics = {
        "actor_loss": actor_loss.mean(),
        "critic_loss": critic_loss,
        "entropy": entropy.mean(),
        "ratio_max": ratios.max(),
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
) -> dict:
    """K-epoch minibatched PPO update on the transposed batch through
    `ops.ppo_fused_t.fused_ppo_grad_t`, in place on ``model`` and ``opt``.

    Per epoch, a permutation of the ``n // tile`` blocks from ``gen`` is cut
    into ``n_mb`` minibatches of ``mb // tile`` blocks; a full batch takes
    every block in order and draws nothing. ``perms`` (K, n_mb, mb // tile)
    replaces the drawn permutations. Returns the metrics averaged over all
    minibatches, as 0-dim tensors (no synchronization)."""
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
) -> tuple[hover.EnvState, dict]:
    """One fully fused train step from given rollout randomness: rollout
    kernel -> GAE -> aux packing -> `ppo_update_t`. Returns the new env
    states and the step's metrics (0-dim tensors)."""
    new_states, obs_t, misc, bootstrap = rollout_from_inputs(
        model, env_states, noise, pool, env_cfg
    )
    rewards, dones, solved = misc[:, 9], misc[:, 10] > 0.5, misc[:, 11] > 0.5
    returns, advs = gae_advantages(
        rewards, misc[:, 8], dones, bootstrap, ppo_cfg.gamma, ppo_cfg.gae_lambda
    )
    aux_t = pack_aux_t(misc, returns, advs)
    metrics = ppo_update_t(model, opt, obs_t, aux_t, gen, ppo_cfg, perms)
    done_f = dones.float()
    metrics["reward_per_step"] = rewards.mean()
    metrics["episodes"] = done_f.sum()
    metrics["solved_frac"] = solved.float().sum() / torch.clamp(done_f.sum(), min=1.0)
    return new_states, metrics


def _require_fused_t(model, env_cfg: EnvConfig, ppo_cfg: PPOConfig, train_cfg: TrainConfig,
                     local_envs: int) -> None:
    """The JAX package's `use_fused_t` gate, and the consistency guard of
    its `make_train_step`; every other branch is not ported yet."""
    if train_cfg.fused_rollout or ppo_cfg.fused_update:
        if float(model.action_std) != float(ppo_cfg.action_std):
            raise ValueError(
                f"model.action_std={model.action_std} != "
                f"ppo_cfg.action_std={ppo_cfg.action_std}: the fused kernels "
                "take the policy std from both places and must agree"
            )
    obs_dim = env_cfg.hist_t * 15
    if ppo_cfg.learn_std:
        raise NotImplementedError("a learned log_std is not ported yet (ROADMAP A6)")
    if not (
        train_cfg.fused_rollout
        and rf.supports(env_cfg, ppo_cfg.learn_std, obs_dim)
        and train_cfg.rollout_steps % min(16, train_cfg.rollout_steps) == 0
    ):
        raise NotImplementedError(
            "only the fused rollout is ported; the unfused rollout_batch (and "
            "randomization) is ROADMAP A8/A12"
        )
    if not ppo_cfg.fused_update:
        raise NotImplementedError("the unfused ppo_update is not ported yet (ROADMAP A8/A12)")
    if ppo_cfg.fused_adam:
        raise NotImplementedError("the Adam step inside the update kernel is ROADMAP B4")
    if ppo_cfg.fused_compute != "f32":
        raise NotImplementedError("fused_compute='bf16' is not ported yet (a later slice)")
    if update_t_tile(ppo_cfg, train_cfg.rollout_steps, local_envs) == 0:
        raise NotImplementedError(
            "no env tile fits this batch; the row-major ppo_update that takes it "
            "is ROADMAP A8/A12"
        )


def make_train_step(
    model: ActorCritic,
    opt: torch.optim.Optimizer,
    env_cfg: EnvConfig,
    ppo_cfg: PPOConfig,
    train_cfg: TrainConfig,
):
    """The fully fused train step: ``train_step(state) -> (state, metrics)``.

    ``model`` and ``opt`` are checked against the configs here; the step
    takes a state that holds these same two objects (as `ppo_init` makes
    it) and updates them in place. Metrics are 0-dim tensors: ``loss``,
    ``actor_loss``, ``critic_loss``, ``entropy``, ``ratio_max``,
    ``reward_per_step``, ``episodes`` and ``solved_frac``."""
    _require_fused_t(model, env_cfg, ppo_cfg, train_cfg, train_cfg.num_envs)

    def train_step(state: PPOTrainState) -> tuple[PPOTrainState, dict]:
        if state.model is not model or state.optimizer is not opt:
            raise ValueError(
                "state.model and state.optimizer must be the model and optimizer "
                "this train step was made for"
            )
        _, noise, pool, _ = fused_inputs(
            model, state.env_states, state.gen, env_cfg,
            train_cfg.rollout_steps, train_cfg.fused_pool,
        )
        env_states, metrics = train_step_from_inputs(
            model, opt, state.env_states, noise, pool, env_cfg, ppo_cfg, state.gen,
        )
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
):
    """`inner` sequential train steps: ``train_loop(state) -> (state,
    metrics)`` with each metric stacked to shape (inner,)."""
    step = make_train_step(model, opt, env_cfg, ppo_cfg, train_cfg)

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


def make_eval_fn(model: ActorCritic, env_cfg: EnvConfig, episodes: int,
                 max_steps: Optional[int] = None):
    """Deterministic evaluation: `episodes` parallel envs flown with the
    actor mean through `hover.step` (reference `evaluate` ppo.py:272-295),
    reporting mean reward, length, solved, survived, late RMS velocity and
    station-keeping fractions.

    ``eval_fn(gen=None, env_states=None)`` resets ``episodes`` envs from
    ``gen`` unless ``env_states`` are given. The loop stops early once every
    episode has finished, which changes nothing: finished episodes add
    nothing."""
    max_steps = max_steps or env_cfg.max_steps
    settle_steps = max_steps // 5

    @torch.no_grad()
    def eval_fn(gen: Optional[torch.Generator] = None,
                env_states: Optional[hover.EnvState] = None) -> dict:
        states = env_states if env_states is not None else hover.reset(gen, env_cfg, n=episodes)
        b = states.x.shape[0]
        dev = states.x.device
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        solved = torch.zeros(b, dtype=torch.bool, device=dev)
        reward_sum = torch.zeros(b, dtype=torch.float32, device=dev)
        length = torch.zeros(b, dtype=torch.int32, device=dev)
        v2_sum = torch.zeros(b, dtype=torch.float32, device=dev)
        v2_n = torch.zeros(b, dtype=torch.float32, device=dev)
        for i in range(max_steps):
            if i % 64 == 63 and bool(finished.all()):
                break
            mean = model.actor_mean(states.hist)
            states, out = hover.step(states, mean, env_cfg)
            active = ~finished
            reward_sum = reward_sum + out.reward * active
            solved = solved | (out.solved & active)
            length = length + active.to(torch.int32)
            late = active & (i >= settle_steps)
            vel2 = ((states.x[:, 1:6:2] - states.vel_target) ** 2).sum(-1)
            v2_sum = v2_sum + vel2 * late
            v2_n = v2_n + late.float()
            finished = finished | out.done
        rms_vel = torch.sqrt(v2_sum / torch.clamp(v2_n, min=1.0))
        # The env's step counter starts at `warmup` after reset, so its
        # timeout fires after max_steps - warmup active steps (the JAX
        # package's round-5 survival cut).
        survived = solved | (length >= max_steps - env_cfg.warmup)
        station = survived & (rms_vel < 0.5)
        return {
            "eval_reward": reward_sum.mean(),
            "eval_length": length.float().mean(),
            "eval_solved": solved.float().mean(),
            "eval_survived": survived.float().mean(),
            "eval_rms_vel_late": rms_vel.mean(),
            "eval_station_keeping": station.float().mean(),
        }

    return eval_fn


def evaluate(model: ActorCritic, env_cfg: EnvConfig, episodes: int,
             gen: torch.Generator) -> dict:
    """One-shot evaluation, as Python floats."""
    return {k: float(v) for k, v in make_eval_fn(model, env_cfg, episodes)(gen).items()}
