"""Mission trajectories, eval-episode tables, and step-response metrics."""

from .metrics import response_metrics
from .targets import EPISODES, episode_n, target_parse
from .trajectories import (
    Trajectory,
    gen_trajectory,
    mission_target,
    sin_trajectory,
    spiral_trajectory,
    stack_trajectories,
)

__all__ = [
    "EPISODES",
    "Trajectory",
    "episode_n",
    "gen_trajectory",
    "mission_target",
    "response_metrics",
    "sin_trajectory",
    "spiral_trajectory",
    "stack_trajectories",
    "target_parse",
]
