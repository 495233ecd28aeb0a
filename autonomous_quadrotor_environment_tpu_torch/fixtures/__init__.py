"""Trained-model fixtures, read from the JAX package's fixture files.

``nn_solved_128_0.msgpack`` is the shipped state controller (ActorCritic,
hidden=128): 100% solved, mean reward 26.8 over 40 deterministic episodes
in the JAX package's eval. ``nn_robust_128_0.msgpack`` is the shipped
robust state controller (ActorCritic, hidden=128), trained under domain
randomization and wind by the calm-to-windy curriculum and a
severity-sampled fine-tune: over 256 episodes of the JAX package's eval on
the CPU at PRNGKey(0), station-keeping 0.977 calm and 0.945 windy, strict
solve 0.980 and 0.570 (`scripts/robust_fixture_rate.py`).
``landing_policy.msgpack`` is the shipped
landing CNN policy (LandingActorCritic, plain first-conv layout, float16
leaves): 100%/98% solved on the 100-episode landing benchmark at seeds 0/7
in the JAX package (reference bar 93.5%). The port reads the files by
path; it imports nothing of the JAX package.
"""

from __future__ import annotations

import os

from ..agents.networks import ActorCritic
from ..device import resolve_device
from ..utils.checkpoint import load_params

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURE_DIR = os.path.join(_REPO, "autonomous_quadrotor_environment_tpu", "fixtures")
SOLVED_CONTROLLER = os.path.join(FIXTURE_DIR, "nn_solved_128_0.msgpack")
LANDING_POLICY = os.path.join(FIXTURE_DIR, "landing_policy.msgpack")
ROBUST_CONTROLLER = os.path.join(FIXTURE_DIR, "nn_robust_128_0.msgpack")


def load_solved_controller(device=None) -> ActorCritic:
    """The shipped solved state controller as an `ActorCritic` on ``device``
    (the CUDA card when None), in eval mode."""
    dev = resolve_device(device)
    model = ActorCritic.from_flax(load_params(SOLVED_CONTROLLER))
    return model.to(dev).eval()


def load_robust_controller(device=None) -> ActorCritic:
    """The shipped robust state controller as an `ActorCritic` on
    ``device`` (the CUDA card when None), in eval mode."""
    dev = resolve_device(device)
    model = ActorCritic.from_flax(load_params(ROBUST_CONTROLLER))
    return model.to(dev).eval()


def load_landing_policy(device=None):
    """The shipped landing CNN policy as a `LandingActorCritic` on
    ``device`` (the CUDA card when None), in eval mode."""
    from ..landing.networks import LandingActorCritic

    dev = resolve_device(device)
    if not os.path.exists(LANDING_POLICY):
        raise FileNotFoundError(f"the landing policy fixture is missing: {LANDING_POLICY}")
    return LandingActorCritic.from_flax(load_params(LANDING_POLICY)).to(dev).eval()
