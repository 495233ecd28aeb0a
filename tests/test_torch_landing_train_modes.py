"""The landing update's shuffle modes against the JAX package, on the CPU:
one train step from JAX-initialized params and envs with JAX's draws and
permutations injected, (a) with blocks as wide as the minibatch and both
reshuffles (a row permutation per update and one per epoch, then
contiguous block slices), (b) on the full batch. (The per-row shuffle is
test_torch_landing_train.py's.)"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.config import PPOConfig as JPPOConfig
from autonomous_quadrotor_environment_tpu.landing import env as jenv
from autonomous_quadrotor_environment_tpu.landing import ppo as jppo
from autonomous_quadrotor_environment_tpu_torch.agents.ppo import make_optimizer
from autonomous_quadrotor_environment_tpu_torch.config import PPOConfig
from autonomous_quadrotor_environment_tpu_torch.landing import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.landing.networks import (
    LandingActorCritic,
    to_flax,
)
from torch_parity import (  # noqa: F401 (one_torch_thread: the fixture below)
    jax_landing_init,
    jax_landing_rollout_draws,
    jax_landing_update_draws,
    one_torch_thread,
)

B, T, POOL, K = 2, 2, 2, 2
MODES = {
    # 4 rows: 2 minibatches of one 2-row block each, rows reshuffled per
    # update and per epoch.
    "block_reshuffled": dict(minibatch_size=2, shuffle_block=2, reshuffle_per_update=True,
                             reshuffle_per_epoch=True),
    "full_batch": dict(minibatch_size=0),
}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def init():
    jcfgs = jenv.LandingConfigs.default(training=True)
    jppo_cfg = JPPOConfig.landing_variant()
    return jcfgs, jax_landing_init(1, jcfgs, jppo_cfg, B, conv_s2d=False)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_update_mode_matches_jax(init, mode):
    """Metrics within rtol 1e-4; each parameter's change within 2e-7 of
    JAX's but for at most 1 in 1e4 elements (an Adam step of lr * sign(g)
    where a near-zero gradient's sign differs); Adam's first moments within
    1e-4 relative Frobenius error (the tolerances of
    test_torch_landing_train.py)."""
    jcfgs, ((cm, cp, jmodel, tx, jstate), (ctrl, tcfgs, states, obs)) = init
    jcfg = dataclasses.replace(JPPOConfig.landing_variant(), k_epochs=K, **MODES[mode])
    jnew, jmet = jax.jit(jppo.make_landing_train_step(jmodel, tx, jcfgs, jcfg, cm, cp, T))(
        jstate)
    _key, k_roll, k_upd = jax.random.split(jstate.key, 3)
    draws, _ = jax_landing_rollout_draws(jstate.env_states.key, k_roll, T, POOL,
                                         np.zeros((T, B), bool))
    cfg = dataclasses.replace(PPOConfig.landing_variant(), k_epochs=K, **MODES[mode])
    plan = tppo.update_plan(cfg, T * B)
    assert plan.full_batch == (mode == "full_batch")
    assert plan.reshuffle == plan.reshuffle_epoch == (mode != "full_batch")
    model = LandingActorCritic.from_flax(jax.device_get(jstate.params))
    before = copy.deepcopy(model)
    opt = make_optimizer(model, cfg)
    state = tppo.LandingTrainState(model, opt, states, obs, torch.Generator())
    step = tppo.make_landing_train_step(model, opt, tcfgs, cfg, ctrl, T)
    _, met = step(state, draws, jax_landing_update_draws(k_upd, plan, K))
    for k, v in met.items():
        np.testing.assert_allclose(float(v), float(jmet[k]), rtol=1e-4, err_msg=k)
    leaves = lambda tree: dict(jax.tree_util.tree_leaves_with_path(jax.device_get(tree)))
    old, got, want = leaves(to_flax(before)), leaves(to_flax(model)), leaves(jnew.params)
    flips = sum(int((np.abs((got[p] - old[p]) - (np.asarray(w) - old[p])) > 2e-7).sum())
                for p, w in want.items())
    assert flips <= 1e-4 * sum(w.size for w in want.values()), flips
    mu = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(mu.parameters(), model.parameters()):
            p.copy_(opt.state[q]["exp_avg"])
    jmu = leaves(jnew.opt_state[0].mu)
    for path, g in leaves(to_flax(mu)).items():
        w = np.asarray(jmu[path])
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), jax.tree_util.keystr(path)

