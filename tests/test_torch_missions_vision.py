"""The port's hybrid mission mode (``missions_eval --vision``: PnP fixes
fused into the INS every 10 frames) against the JAX package's runner, on the
CPU: 2 episodes x 41 steps, fixes due at steps 1, 11, 21, 31 and 41, each
episode's sensor draws walked down the JAX package's key chains and
injected (`torch_parity.jax_mission_sensor_draws`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.apps import missions_eval as jme
from autonomous_quadrotor_environment_tpu.config import EnvConfig as JEnvConfig
from autonomous_quadrotor_environment_tpu.config import SensorConfig as JSensorConfig
from autonomous_quadrotor_environment_tpu.missions import target_parse as jtarget_parse
from autonomous_quadrotor_environment_tpu.utils import load_params
from autonomous_quadrotor_environment_tpu_torch.apps import missions_eval as me
from autonomous_quadrotor_environment_tpu_torch.apps.robust_eval import load_policy
from autonomous_quadrotor_environment_tpu_torch.config import EnvConfig, SensorConfig
from autonomous_quadrotor_environment_tpu_torch.fixtures import SOLVED_CONTROLLER
from autonomous_quadrotor_environment_tpu_torch.missions import stack_trajectories, target_parse
from torch_parity import (  # noqa: F401 (one_torch_thread: the fixture below)
    jax_mission_sensor_draws,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEPS, SEED, EPISODES = 41, 0, (0, 1)
# The --sensors parity tolerance of tests/test_torch_missions_cli.py.
RTOL, ATOL = 1e-4, 1e-7
# Episode 0 hovers over the board's center, where the detector's corner
# picks (plateaus of two pixels, sub-pixel fits from either side) turn on
# last bits: the closed loop grows a fix's 1e-6 m difference about tenfold
# by the next fix. The JAX package's own op-by-op run of this episode and
# its jitted one differ by 4.8e-3 in the mean tracking error; the port is
# held to the jitted one at 1e-2 there. The mean INS error (log column 17)
# is the fixes' noise: the JAX package's op-by-op and jitted runs differ by
# 6.3e-2 (episode 0) and 1.0e-2 (episode 1) in it, the port and the
# op-by-op run by 2.6e-2 and 3e-5; it is not held to a run.
# `python scripts/vision_jit_gap.py` prints these gaps (this case, the three
# runs). Every log entry up to the second fix (steps 0-10) is held at 1e-4
# in both episodes.
HOVER_RTOL, EARLY_ATOL = 1e-2, 1e-4


@pytest.fixture(scope="module")
def logs():
    jcfg = JEnvConfig(n_steps=STEPS, direct_control=True, training=False)
    jmodel = JActorCritic(hidden=128)
    jparams = load_params(SOLVED_CONTROLLER,
                          jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 75))))
    want, want_sens = [], []
    for vision, out in ((True, want), (False, want_sens)):
        run = jme.make_rl_mission_runner(jcfg, jmodel, jparams, JSensorConfig(), True, STEPS,
                                         use_vision=vision)
        for ep in EPISODES:
            traj = jme._make_traj(jtarget_parse(ep), jcfg.dt)
            out.append(np.asarray(run(traj, jax.random.fold_in(jax.random.PRNGKey(SEED), ep))))
    cfg = EnvConfig(n_steps=STEPS, direct_control=True, training=False)
    model = load_policy(SOLVED_CONTROLLER, 128, torch.device("cpu"))
    traj = stack_trajectories([me._make_traj(target_parse(ep), cfg.dt) for ep in EPISODES])
    draws = jax_mission_sensor_draws(SEED, len(EPISODES), STEPS)
    got = me.make_rl_mission_runner(cfg, model, SensorConfig(), True, STEPS,
                                    use_vision=True)(traj, draws)
    return np.stack(want), np.stack(want_sens), got


def test_vision_mission_matches_jax_per_episode(logs):
    """Episode 1's mean tracking error (log column 16) as the JAX runner's
    at the --sensors tolerance, the hover episode 0's at `HOVER_RTOL`;
    every log entry up to the second fix at `EARLY_ATOL`; the first fix
    (step 1), made at states that still agree, lands the INS within 2e-6 m
    of JAX's (the fix's weight, 0.2, times its position's 1e-5 m)."""
    want, _, got = logs
    assert got.shape == want.shape == (len(EPISODES), STEPS, 18)
    np.testing.assert_allclose(got[1, :, 16].mean(), want[1, :, 16].mean(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0, :, 16].mean(), want[0, :, 16].mean(), rtol=HOVER_RTOL)
    np.testing.assert_allclose(got[:, :11], want[:, :11], rtol=0, atol=EARLY_ATOL)
    np.testing.assert_allclose(got[:, 1, 17], want[:, 1, 17], rtol=0, atol=2e-6)


def test_vision_fixes_move_the_ins(logs):
    """The fixes act: at every due step the INS error departs from the
    --sensors run's (same draws), on both sides alike."""
    want, want_sens, got = logs
    for step in (1, 11, 21, 31):
        assert np.all(np.abs(want[:, step, 17] - want_sens[:, step, 17]) > 1e-4), step
        assert np.all(np.abs(got[:, step, 17] - want_sens[:, step, 17]) > 1e-4), step
