"""The port's PI landing oracle against the JAX package's, on the CPU: no
render and no CNN, so it holds the frozen controller and the landing
geometry apart from the render kernel and the convolutions."""

import jax
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.fixtures import load_solved_controller as jload_ctrl
from autonomous_quadrotor_environment_tpu.landing import env as jenv
from autonomous_quadrotor_environment_tpu.landing.oracle import oracle_landing_eval as joracle
from autonomous_quadrotor_environment_tpu_torch.fixtures import load_solved_controller
from autonomous_quadrotor_environment_tpu_torch.landing import LandingConfigs, ResetDraws
from autonomous_quadrotor_environment_tpu_torch.landing import oracle_landing_eval
from torch_parity import one_torch_thread, t  # noqa: F401

EPISODES = 4

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_oracle_matches_jax():
    """4 episodes of 1500 steps from JAX's start draws: solved, finished
    and the landing times equal; the cumulative |v| within rtol 1e-4."""
    cfgs_j = jenv.LandingConfigs.default(training=False)
    cm, cp = jload_ctrl()
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda k: joracle(cm, cp, cfgs_j, EPISODES, k))(key)

    def starts(k):
        k_marker, k_z, k_xy, _ = jax.random.split(k, 4)
        return (jax.random.normal(k_marker, (2,)), jax.random.uniform(k_z, ()),
                jax.random.uniform(k_xy, (2,)))

    marker, z_u, xy_u = jax.vmap(starts)(jax.random.split(key, EPISODES))
    draws = ResetDraws(t(marker), t(z_u), t(xy_u), torch.zeros(EPISODES, 3))
    got = oracle_landing_eval(load_solved_controller("cpu"), LandingConfigs.default(False),
                              EPISODES, draws=draws)
    for k in ("oracle_solved", "oracle_finished", "oracle_time_s"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(got["oracle_delta_v"]), float(want["oracle_delta_v"]),
                               rtol=1e-4)
    assert float(got["oracle_solved"]) == 1.0
