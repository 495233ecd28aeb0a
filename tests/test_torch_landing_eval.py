"""The port's landing benchmark against the JAX package, on the CPU: the
eval with JAX's draws injected and the shipped policy's quality at a
small slice of the benchmark (the oracle and the CLI have files of
their own)."""

import jax
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.fixtures import load_solved_controller as jload_ctrl
from autonomous_quadrotor_environment_tpu.landing import env as jenv
from autonomous_quadrotor_environment_tpu.landing.networks import LandingActorCritic as JLandingAC
from autonomous_quadrotor_environment_tpu.landing.ppo import make_landing_eval_fn as jeval_fn
from autonomous_quadrotor_environment_tpu_torch.fixtures import (
    LANDING_POLICY,
    load_landing_policy,
    load_solved_controller,
)
from autonomous_quadrotor_environment_tpu_torch.landing import LandingConfigs
from autonomous_quadrotor_environment_tpu_torch.landing import make_landing_eval_fn
from autonomous_quadrotor_environment_tpu_torch.ops import render_kernel as rk
from autonomous_quadrotor_environment_tpu_torch.utils.checkpoint import load_params
from torch_parity import (  # noqa: F401 (one_torch_thread: the fixture below)
    jax_landing_noise,
    jax_landing_reset_draws,
    one_torch_thread,
    t,
)

EPISODES = 4
KEYS = ("eval_reward", "eval_solved", "eval_time_s", "eval_finished")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_eval_matches_jax():
    """episodes=4, max_decisions=6, eval-mode sensors on, JAX's draws
    injected: eval_reward within rtol 1e-4, the other metrics equal."""
    cfgs_j = jenv.LandingConfigs.default(training=False)
    cm, cp = jload_ctrl()
    # The fixture as JAX's `load_params` gives it (test_torch_landing.py
    # holds the two readers equal), without flax's slow CNN init.
    lm, lp = JLandingAC(), jax.tree.map(jax.numpy.asarray, load_params(LANDING_POLICY))
    key = jax.random.PRNGKey(7)
    want = jax.jit(jeval_fn(lm, cfgs_j, cm, cp, EPISODES, max_decisions=6))(lp, key)

    cfgs = LandingConfigs.default(training=False)
    draws, state_keys = jax_landing_reset_draws(jax.random.split(key, EPISODES))
    noise, _ = jax_landing_noise(state_keys, 7 * cfgs.landing.task_interval)
    fn = make_landing_eval_fn(load_landing_policy("cpu"), cfgs, load_solved_controller("cpu"),
                              EPISODES, max_decisions=6)
    got = fn(draws=draws, noise=noise)
    assert set(got) == set(want) == set(KEYS)
    np.testing.assert_allclose(float(got["eval_reward"]), float(want["eval_reward"]), rtol=1e-4)
    for k in KEYS[1:]:
        assert float(got[k]) == float(want[k]), k
    assert rk.render_nadir_batch.launches == 0


def test_shipped_policy_lands_on_the_cpu():
    """The JAX package's own quality check (tests/test_landing.py
    test_landing_fixture_lands) in the port, with its own seeded
    generator: 4 episodes, 100 decisions."""
    cfgs = LandingConfigs.default(training=False)
    fn = make_landing_eval_fn(load_landing_policy("cpu"), cfgs, load_solved_controller("cpu"),
                              EPISODES, max_decisions=100)
    out = fn(torch.Generator().manual_seed(11))
    assert float(out["eval_finished"]) == 1.0
    assert float(out["eval_solved"]) >= 0.75, {k: float(v) for k, v in out.items()}
