"""Declarative eval-episode table for the classical/RL comparison benchmark.

The port's own copy of `missions/targets.py` in the JAX package (the
reference's target_parser, environment/controller/target_parser.py:3-52):
7 point-tracking episodes (mission class 1) and 7 spiral episodes (class
3), flown by the PID and RL mission evals.
"""

from __future__ import annotations

import math
from typing import NamedTuple


class EpisodeSpec(NamedTuple):
    mission_class: int  # 1 = point-to-point ramp, 3 = spiral
    time: float         # ramp duration [s] (class 1 only)
    target: tuple       # class 1: (x, y, z); class 3: spiral args


EPISODES: tuple[EpisodeSpec, ...] = (
    EpisodeSpec(1, 1.0, (0.0, 0.0, 0.0)),
    EpisodeSpec(1, 0.01, (1.0, 0.0, 0.0)),
    EpisodeSpec(1, 0.01, (0.0, 0.0, 1.0)),
    EpisodeSpec(1, 1.0, (1.0, 1.0, 1.0)),
    EpisodeSpec(1, 2.0, (1.0, -2.0, 3.0)),
    EpisodeSpec(1, 2.0, (1.0, 1.0, -2.0)),
    EpisodeSpec(1, 8.0, (10.0, 10.0, 10.0)),
    EpisodeSpec(3, 0.0, (4000, 5000, 2.0, math.pi / 10, 0.3, (0.0, 0.0, 0.0))),
    EpisodeSpec(3, 0.0, (4000, 5000, 1.0, math.pi / 10, 0.3, (0.0, 0.0, 0.0))),
    EpisodeSpec(3, 0.0, (4000, 5000, 1.0, math.pi / 10, 2.0, (0.0, 0.0, 0.0))),
    EpisodeSpec(3, 0.0, (4000, 5000, 1.0, math.pi / 4, 0.3, (0.0, 0.0, 0.0))),
    EpisodeSpec(3, 0.0, (4000, 5000, 1.0, math.pi / 3, 0.3, (0.0, 0.0, 0.0))),
    EpisodeSpec(3, 0.0, (4000, 5000, 1.0, math.pi / 3, 1.0, (0.0, 0.0, 0.0))),
    EpisodeSpec(3, 0.0, (4000, 5000, 0.5, math.pi / 3, 1.0, (0.0, 0.0, 0.0))),
)


def target_parse(n_episode: int) -> EpisodeSpec:
    return EPISODES[n_episode]


def episode_n() -> int:
    return len(EPISODES)
