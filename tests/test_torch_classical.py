"""The port's classical comparison against the JAX package's, on the CPU:
the reference's seeded start states, the PID, LQR and RL runners on 4 of
them for 60 steps against the JAX package's logs, and the port's own full
PID legs (20 x 500) at the reference's 0% and 100%."""

import numpy as np
import pytest

from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.apps import classical_compare as jcc
from autonomous_quadrotor_environment_tpu.fixtures import load_solved_controller as jload_solved
from autonomous_quadrotor_environment_tpu_torch.apps import classical_compare as cc
from autonomous_quadrotor_environment_tpu_torch.baselines import (
    VELOCITY_GAINS,
    VELOCITY_GAINS_UNCLIPPED,
)
from autonomous_quadrotor_environment_tpu_torch.fixtures import load_solved_controller
from torch_parity import port_env_config

STEPS = 60
# Logs [vel, ang, ang_vel, effort] after 60 closed-loop steps: the two
# packages' float32 arithmetic differs in last bits (library
# transcendentals, the 3x3 solve, summation order), and the Euler-rate
# columns divide angle differences by dt = 0.01 (x100). Held: 1e-4
# relative and absolute, 1e-3 on the Euler rates.
RTOL, ATOL, RATE_ATOL = 1e-4, 1e-4, 1e-3


def test_reference_start_states_equal_jax():
    np.testing.assert_allclose(cc.reference_start_states(), jcc.reference_start_states(),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(cc.reference_start_states(5, 3),
                               jcc.reference_start_states(5, 3), rtol=0, atol=1e-7)


def _assert_logs_close(got, want):
    assert got.shape == want.shape
    for cols, atol in ((slice(0, 6), ATOL), (slice(6, 9), RATE_ATOL), (slice(9, 13), ATOL)):
        np.testing.assert_allclose(got[..., cols], want[..., cols], rtol=RTOL, atol=atol)


@pytest.mark.parametrize("leg", ["pid", "pid_unclipped", "lqr", "lqr_unclipped", "rl"])
def test_runners_match_jax(leg, monkeypatch):
    monkeypatch.setattr(jcc, "MAX_STEPS", STEPS)
    monkeypatch.setattr(cc, "MAX_STEPS", STEPS)
    starts = jcc.reference_start_states()[[0, 5, 11, 16]]
    cfg = cc.leg_env(leg)
    jcfg = jcc.EnvConfig(**{k: getattr(cfg, k) for k in (
        "n_steps", "warmup", "direct_control", "training", "clipped")})
    assert port_env_config(jcfg) == cfg
    if leg.startswith("pid"):
        jg = jcc.VELOCITY_GAINS if leg == "pid" else jcc.VELOCITY_GAINS_UNCLIPPED
        want = jcc.run_pid(jcfg, starts, jg)
        got = cc.run_pid(cfg, starts, VELOCITY_GAINS if leg == "pid"
                         else VELOCITY_GAINS_UNCLIPPED, device="cpu")
    elif leg.startswith("lqr"):
        want = jcc.run_lqr(jcfg, starts)
        got = cc.run_lqr(cfg, starts, device="cpu")
    else:
        jmodel, jparams = jload_solved()
        assert isinstance(jmodel, JActorCritic)
        want = jcc.run_rl(jcfg, starts, jmodel, jparams)
        got = cc.run_rl(cfg, starts, load_solved_controller(device="cpu"))
    _assert_logs_close(got, np.asarray(want))


@pytest.mark.parametrize("leg,rate", [("pid", 0.0), ("pid_unclipped", 1.0)])
def test_full_pid_legs_read_the_reference_rates(leg, rate):
    """20 episodes x 500 steps from the reference's starts: the clipped PID
    solves none, the unclipped one all (the reference's own logs: 0% and
    100%)."""
    gains = VELOCITY_GAINS if leg == "pid" else VELOCITY_GAINS_UNCLIPPED
    cfg = cc.leg_env(leg)
    log = cc.run_pid(cfg, cc.reference_start_states(), gains, device="cpu")
    assert log.shape == (cc.N_EPISODES, cc.MAX_STEPS, 13)
    assert cc.analyze(log, cfg)["success_rate"] == rate
