"""The port's robust trainer and evals against the JAX package's, on the
CPU: one robust row-major train step (the autograd update and the B3 and
B4 plain versions), and the windy eval and forensic eval of the shipped
robust controller. Every draw is the JAX package's own, walked down its
per-env key chains (`torch_parity`).

Tolerances: the train step as tests/test_torch_train_rowmajor.py holds it,
the evals as tests/test_torch_train.py holds the calm eval."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu import config as jcfg
from autonomous_quadrotor_environment_tpu.agents import make_train_step as jmake_train_step
from autonomous_quadrotor_environment_tpu.agents import ppo_init as jppo_init
from autonomous_quadrotor_environment_tpu.agents.ppo import make_eval_fn as jmake_eval_fn
from autonomous_quadrotor_environment_tpu.agents.ppo import (
    make_forensic_eval_fn as jmake_forensic_eval_fn,
)
from autonomous_quadrotor_environment_tpu.apps.robust_eval import _taxonomy as jtaxonomy
from autonomous_quadrotor_environment_tpu.envs import hover as jhover
from autonomous_quadrotor_environment_tpu.fixtures import load_robust_controller as jload_robust
from autonomous_quadrotor_environment_tpu_torch import config as tcfg
from autonomous_quadrotor_environment_tpu_torch.agents import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
from autonomous_quadrotor_environment_tpu_torch.apps.robust_eval import _taxonomy
from autonomous_quadrotor_environment_tpu_torch.fixtures import load_robust_controller
from torch_parity import (
    assert_params_close,
    assert_states_close,
    jax_perms,
    jax_robust_rollout_draws,
    jax_step_gusts,
    n,
    one_torch_thread,  # noqa: F401  (the module's fixture)
    port_env_config,
    port_states,
    t,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, HIDDEN, STEPS = 16, 32, 8
WINDY = jcfg.RandomizationConfig(enabled=True)
ROLL_ENV = jcfg.EnvConfig(bb_scale=0.15, randomization=dataclasses.replace(WINDY, gust_period=7))
TRAIN_PPO = dict(k_epochs=2, minibatch_size=64, shuffle_block=8)


@pytest.fixture(scope="module")
def jax_robust_step():
    """One JAX row-major train step on ROLL_ENV (autograd update), its
    start state, result, and every draw of its rollout and update."""
    jppo = jcfg.PPOConfig(**TRAIN_PPO)
    jtrain = jcfg.TrainConfig(num_envs=B, rollout_steps=STEPS, network_size=HIDDEN)
    jmodel, tx, jstate = jppo_init(jax.random.PRNGKey(0), ROLL_ENV, jppo, jtrain)
    jnew, mj = jax.jit(jmake_train_step(jmodel, tx, ROLL_ENV, jppo, jtrain))(jstate)
    _, k_roll, k_upd = jax.random.split(jstate.key, 3)
    draws, _ = jax_robust_rollout_draws(jmodel, jstate.params, jstate.env_states, k_roll,
                                        ROLL_ENV, STEPS, reset_pool=0)
    return jstate, jnew, mj, draws, k_upd


@pytest.mark.parametrize("update", ["autograd", "fused", "fused_adam"])
def test_robust_train_step_matches_jax(jax_robust_step, update):
    """A robust train step takes the row-major branch (the rollout kernel
    refuses randomization) and matches the JAX package's step from the same
    state and draws: the autograd update, and the B3 and B4 plain versions
    (the CPU's path of `fused_update` and `fused_adam`) against the same JAX
    step, at tests/test_torch_train_rowmajor.py's tolerances (params within
    lr * 0.05, metrics rtol 5e-4, env states 1e-5)."""
    jstate, jnew, mj, draws, k_upd = jax_robust_step
    flags = {"autograd": {}, "fused": dict(fused_update=True),
             "fused_adam": dict(fused_update=True, fused_adam=True)}[update]
    pcfg = tcfg.PPOConfig(**TRAIN_PPO, **flags)
    ptrain = tcfg.TrainConfig(num_envs=B, rollout_steps=STEPS, network_size=HIDDEN,
                              fused_rollout=True)
    env_cfg = port_env_config(ROLL_ENV)
    model = ActorCritic.from_flax(jax.tree.map(np.asarray, jstate.params))
    opt = tppo.make_optimizer(model, pcfg)
    assert not tppo.uses_fused_rollout(env_cfg, pcfg, ptrain)
    assert tppo.train_branch(model, env_cfg, pcfg, ptrain) == "rowmajor"
    plan = tppo.update_plan(pcfg, STEPS * B, plain_adam=True)
    assert plan.branch == update
    perms = torch.from_numpy(jax_perms(k_upd, pcfg.k_epochs, STEPS * B // plan.block, plan.n_mb,
                                       plan.mb // plan.block))
    new_states, mt = tppo.rowmajor_step_from_inputs(
        model, opt, port_states(jstate.env_states), env_cfg, pcfg, ptrain, perms=perms, **draws)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=5e-4, atol=1e-6, err_msg=k)
    assert_params_close(model, jnew.params, atol=jcfg.PPOConfig().lr * 0.05)
    assert_states_close(new_states, jnew.env_states, rtol=1e-5, atol=1e-5)


EVAL_ENV = jcfg.EnvConfig(randomization=dataclasses.replace(WINDY, gust_period=40))
EPISODES, MAX_STEPS = 16, 150


@pytest.fixture(scope="module")
def windy_eval():
    """The robust fixture over EPISODES windy episodes of MAX_STEPS steps
    (gust_period 40: resamples at i = 41, 81, 121) from JAX's reset states,
    each step's gust from each env's key chain: JAX's eval and forensic
    eval, and the port's inputs."""
    jmodel, jparams = jload_robust()
    key = jax.random.PRNGKey(5)
    js = jax.jit(jax.vmap(lambda k: jhover.reset(k, EVAL_ENV)))(jax.random.split(key, EPISODES))
    gusts, _ = jax_step_gusts(js.key, MAX_STEPS)
    mj = jax.jit(jmake_eval_fn(jmodel, EVAL_ENV, EPISODES, MAX_STEPS))(jparams, key)
    rj = jax.jit(jmake_forensic_eval_fn(jmodel, EVAL_ENV, EPISODES, MAX_STEPS))(jparams, key)
    return js, t(gusts), mj, rj


def test_windy_eval_fn_matches_jax(windy_eval):
    """`make_eval_fn` on a windy env: the discrete metrics exactly, the
    others within 1e-4 (test_torch_train.py's eval tolerance)."""
    js, gusts, mj, _ = windy_eval
    model = load_robust_controller(device="cpu")
    mt = tppo.make_eval_fn(model, port_env_config(EVAL_ENV), EPISODES, MAX_STEPS)(
        env_states=port_states(js), gust_eps=gusts)
    assert set(mt) == set(mj)
    for k in ("eval_solved", "eval_survived", "eval_length", "eval_station_keeping"):
        assert float(mt[k]) == float(mj[k]), k
    for k in ("eval_reward", "eval_rms_vel_late"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4, atol=1e-4, err_msg=k)


def test_windy_forensic_eval_matches_jax(windy_eval):
    """`make_forensic_eval_fn`: every per-episode record of the JAX package's
    (the discrete ones exactly, the rest within 1e-4), its means equal to
    `make_eval_fn`'s, and `_taxonomy` of the records equal to the JAX
    package's on the same records."""
    js, gusts, mj, rj = windy_eval
    model = load_robust_controller(device="cpu")
    rt = tppo.make_forensic_eval_fn(model, port_env_config(EVAL_ENV), EPISODES, MAX_STEPS)(
        env_states=port_states(js), gust_eps=gusts)
    assert set(rt) == set(rj)
    for k in ("solved", "survived", "station", "length"):
        np.testing.assert_array_equal(n(rt[k]), np.asarray(rj[k]), err_msg=k)
    for k in ("severity", "mass_factor", "kf_mean", "peak_gust", "rms_vel", "reward",
              "sat_frac"):
        np.testing.assert_allclose(n(rt[k]), np.asarray(rj[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    assert float(rt["station"].float().mean()) == float(mj["eval_station_keeping"])
    rec = {k: [round(float(x), 5) for x in np.asarray(v)] for k, v in rj.items()}
    assert _taxonomy(rec) == jtaxonomy(rec)
    ported = {k: [round(float(x), 5) for x in n(v.float())] for k, v in rt.items()}
    assert _taxonomy(ported)["crashed"]["n"] == jtaxonomy(rec)["crashed"]["n"]
