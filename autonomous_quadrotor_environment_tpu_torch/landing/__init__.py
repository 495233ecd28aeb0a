"""Hierarchical visual-landing task of the port: env, CNN policy, PPO
trainer, eval and the PI oracle."""

from .env import (
    LandingConfigs,
    LandingObs,
    LandingState,
    LandingStepOut,
    ResetDraws,
    landing_reset,
    landing_step,
    landing_step_autoreset,
)
from .networks import LandingActorCritic
from .oracle import oracle_landing_eval
from .ppo import landing_eval, make_landing_eval_fn
from .reward import visual_reward

__all__ = [
    "LandingActorCritic",
    "LandingConfigs",
    "LandingObs",
    "LandingState",
    "LandingStepOut",
    "ResetDraws",
    "landing_eval",
    "landing_reset",
    "landing_step",
    "landing_step_autoreset",
    "make_landing_eval_fn",
    "oracle_landing_eval",
    "visual_reward",
]
