"""Data-parallel training of the visual-landing policy over ranks.

Counterpart of `parallel/dp_landing.py` in the JAX package, in the layout
of `parallel.dp`: the landing model and optimizer replicated, the landing
envs and their current observation split over the ranks, each rank its own
generator, each minibatch's gradients and each step's metrics averaged over
the ranks (the JAX form of the reference's mother/child data collection,
visual_landing/rl_worker.py:267-342). On the card every rank renders its
own envs' images through the render kernel (B5), once per decision and per
reset batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import PPOConfig
from ..landing.env import LandingConfigs
from ..landing.ppo import landing_ppo_init, make_landing_train_loop, make_landing_train_step
from .dp import DPMesh, rank_generator, shard


def landing_ppo_init_sharded(seed: int, cfgs: LandingConfigs, ppo_cfg: PPOConfig, num_envs: int,
                             ctrl_model: Any, mesh: DPMesh, conv_dtype=torch.float32,
                             conv_s2d: bool = False):
    """`landing.ppo.landing_ppo_init` on every rank (the same model and
    optimizer everywhere), the global ``num_envs`` fresh episodes split over
    the ranks, each rank with its own generator; on ``mesh.device``
    (``ctrl_model`` must live there)."""
    model, opt, state = landing_ppo_init(seed, cfgs, ppo_cfg, num_envs, ctrl_model, conv_dtype,
                                         conv_s2d, device=mesh.device)
    state = dataclasses.replace(state, env_states=shard(state.env_states, num_envs, mesh),
                                obs=shard(state.obs, num_envs, mesh),
                                gen=rank_generator(state.gen, mesh, seed))
    return model, opt, state


def make_landing_parallel_train_step(model, opt, cfgs: LandingConfigs, ppo_cfg: PPOConfig,
                                     ctrl_model: Any, rollout_steps: int, mesh: DPMesh,
                                     reset_pool: int = 2, image_dtype=None):
    """`landing.ppo.make_landing_train_step` on this rank's envs, each
    minibatch's gradients and the step's metrics averaged over the ranks."""
    return make_landing_train_step(model, opt, cfgs, ppo_cfg, ctrl_model, rollout_steps,
                                   reset_pool, image_dtype, grad_reduce=mesh.mean,
                                   metric_reduce=mesh.mean_metrics)


def make_landing_parallel_train_loop(model, opt, cfgs: LandingConfigs, ppo_cfg: PPOConfig,
                                     ctrl_model: Any, rollout_steps: int, mesh: DPMesh,
                                     inner: int, reset_pool: int = 2, image_dtype=None):
    """``inner`` sequential `make_landing_parallel_train_step` steps, the
    metrics stacked to (inner,)."""
    return make_landing_train_loop(model, opt, cfgs, ppo_cfg, ctrl_model, rollout_steps, inner,
                                   reset_pool, image_dtype, grad_reduce=mesh.mean,
                                   metric_reduce=mesh.mean_metrics)
