"""The port's mission tables, target lookup and response metrics against the
JAX package's, on the CPU: the eval-episode table, every trajectory
generator's tables (built in float64 numpy and stored as float32 on both
sides: equal to the bit), `mission_target` up to and past a table's end,
one table or a batch, and `response_metrics`."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu import missions as jm
from autonomous_quadrotor_environment_tpu_torch import missions as tm
from torch_parity import n


def test_episode_table_equals_jax():
    assert tuple(tuple(e) for e in tm.EPISODES) == tuple(tuple(e) for e in jm.EPISODES)
    assert tm.episode_n() == jm.episode_n() == 14
    assert tuple(tm.target_parse(8)) == tuple(jm.target_parse(8))


TABLES = {
    "ramp": lambda m: m.gen_trajectory(300, 120, np.array([1.0, -2.0, 3.0])),
    "ramp_additive": lambda m: m.gen_trajectory(200, 50, np.array([0.5, 0.0, -1.0]),
                                                additive=np.arange(14) * 0.1),
    "one_step": lambda m: m.gen_trajectory(100, 1, np.array([1.0, 0.0, 0.0])),
    "velocity": lambda m: m.gen_trajectory(250, 250, np.zeros(3),
                                           velocity=np.array([0.3, -0.2, 0.5])),
    "sin": lambda m: m.sin_trajectory(400, 2.0, 0.3, np.array([1.0, 2.0, 3.0]),
                                      np.array([0.5, -1.0, 0.0])),
    "spiral": lambda m: m.spiral_trajectory(300, 500, 1.0, math.pi / 3, 0.3,
                                            np.array([0.1, 0.2, 0.0])),
}


@pytest.mark.parametrize("name", list(TABLES))
def test_trajectory_tables_equal_jax(name):
    want, got = TABLES[name](jm), TABLES[name](tm)
    assert got.positions.dtype == torch.float32 and got.dt == want.dt
    np.testing.assert_array_equal(n(got.positions), np.asarray(want.positions))
    np.testing.assert_array_equal(n(got.velocities), np.asarray(want.velocities))


@pytest.mark.parametrize("name", ["ramp", "velocity", "spiral"])
def test_mission_target_up_to_and_past_the_end(name):
    """Past the table's end the target drifts on by the last velocity times
    dt a step; a step index given as a tensor, and a batch of tables, give
    the same rows."""
    want_t, got_t = TABLES[name](jm), TABLES[name](tm)
    last = got_t.positions.shape[0] - 1
    other = tm.gen_trajectory(last + 1, 10, np.array([2.0, 1.0, -1.0]))
    batch = tm.stack_trajectories([got_t, other])
    for i in (0, 1, 17, last - 1, last, last + 1, last + 40):
        want = np.asarray(jm.mission_target(want_t, jnp.asarray(i)))
        np.testing.assert_allclose(n(tm.mission_target(got_t, i)), want, rtol=1e-6, atol=1e-7)
        got = tm.mission_target(got_t, torch.tensor(i))
        np.testing.assert_allclose(n(got), want, rtol=1e-6, atol=1e-7)
        assert torch.equal(tm.mission_target(batch, torch.tensor(i))[0], got)
    drift = n(tm.mission_target(got_t, last + 40) - tm.mission_target(got_t, last))
    np.testing.assert_allclose(drift[0:5:2], 40 * 0.01 * n(got_t.velocities[-1]), atol=1e-5)


def test_response_metrics_equal_jax():
    rng = np.random.RandomState(0)
    y = np.cumsum(rng.normal(size=(13, 500)) * 0.01, axis=1)
    y[0] += np.linspace(0.0, 1.0, 500)
    target = [1.0, 0.0, 0.02]
    args = dict(control_effort=3.0, abs_error=12.5, env_max_steps=500)
    assert tm.response_metrics(y, target, **args) == jm.response_metrics(y, target, **args)
