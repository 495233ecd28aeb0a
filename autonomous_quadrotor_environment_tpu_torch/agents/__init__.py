"""Policy networks, GAE and the PPO trainer of the port."""

from .gae import gae_advantages
from .networks import ActorCritic, DiagGaussian
from .ppo import (
    PPOTrainState,
    Rollout,
    evaluate,
    make_eval_fn,
    make_forensic_eval_fn,
    make_train_loop,
    make_train_step,
    ppo_init,
    ppo_update,
    ppo_update_t,
    rollout_batch,
    rollout_batch_fused,
    rollout_batch_fused_raw,
    rowmajor_step_from_inputs,
    train_branch,
    update_plan,
)

__all__ = [
    "ActorCritic",
    "DiagGaussian",
    "PPOTrainState",
    "Rollout",
    "evaluate",
    "gae_advantages",
    "make_eval_fn",
    "make_forensic_eval_fn",
    "make_train_loop",
    "make_train_step",
    "ppo_init",
    "ppo_update",
    "ppo_update_t",
    "rollout_batch",
    "rollout_batch_fused",
    "rollout_batch_fused_raw",
    "rowmajor_step_from_inputs",
    "train_branch",
    "update_plan",
]
