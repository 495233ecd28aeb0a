"""Hierarchical visual-landing task of the port: env, CNN policy, eval and
the PI oracle. The landing trainer is still to be ported (ROADMAP A13b)."""

from .env import (
    LandingConfigs,
    LandingObs,
    LandingState,
    LandingStepOut,
    ResetDraws,
    landing_reset,
    landing_step,
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
    "make_landing_eval_fn",
    "oracle_landing_eval",
    "visual_reward",
]
