"""The port's row-major train step (`make_train_step` off the fully fused
branch) against the JAX package's, on the CPU: one whole step at the
trainer's unfused defaults (per-step auto-reset, autograd update) and one
with the rollout kernel and the Adam step inside the update kernel (B1 +
B4), each from the same state with JAX's draws injected; the branch every
configuration takes; and the train loop against sequential steps.

Tolerances: updated parameters within atol lr * 0.05 and metrics within
rtol 5e-4 (tests/test_ops.py's fused-vs-XLA update test), env states as
tests/test_torch_rollout.py holds them."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu import config as jcfg
from autonomous_quadrotor_environment_tpu.agents import make_train_step as jmake_train_step
from autonomous_quadrotor_environment_tpu.agents import ppo_init as jppo_init
from autonomous_quadrotor_environment_tpu.envs import hover as jhover
from autonomous_quadrotor_environment_tpu.ops import rollout_fused as jrf
from autonomous_quadrotor_environment_tpu_torch import config as tcfg
from autonomous_quadrotor_environment_tpu_torch.agents import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
from torch_parity import (
    assert_params_close,
    assert_states_close,
    jax_perms,
    jax_rollout_draws,
    port_env_config,
    port_states,
    t,
)

STEPS, B, HIDDEN = 8, 16, 32
ROWS = STEPS * B


def _jax_step(env_cfg, ppo_kw, train_kw):
    jppo = jcfg.PPOConfig(**ppo_kw)
    jtrain = jcfg.TrainConfig(num_envs=B, rollout_steps=STEPS, network_size=HIDDEN, **train_kw)
    jmodel, tx, jstate = jppo_init(jax.random.PRNGKey(0), env_cfg, jppo, jtrain)
    jnew, mj = jax.jit(jmake_train_step(jmodel, tx, env_cfg, jppo, jtrain))(jstate)
    _, k_roll, k_upd = jax.random.split(jstate.key, 3)
    return jmodel, jstate, jnew, mj, k_roll, k_upd


def _port_step(jstate, env_cfg, ppo_kw, train_kw, k_upd, **draws):
    pcfg = tcfg.PPOConfig(**ppo_kw)
    ptrain = tcfg.TrainConfig(num_envs=B, rollout_steps=STEPS, network_size=HIDDEN, **train_kw)
    model = ActorCritic.from_flax(jax.tree.map(np.asarray, jstate.params))
    opt = tppo.make_optimizer(model, pcfg)
    assert tppo.train_branch(model, port_env_config(env_cfg), pcfg, ptrain) == "rowmajor"
    plan = tppo.update_plan(pcfg, ROWS, plain_adam=True)
    perms = None
    if not plan.full_batch:
        perms = torch.from_numpy(jax_perms(k_upd, pcfg.k_epochs, ROWS // plan.block, plan.n_mb,
                                           plan.mb // plan.block))
    new_states, mt = tppo.rowmajor_step_from_inputs(
        model, opt, port_states(jstate.env_states), port_env_config(env_cfg), pcfg, ptrain,
        perms=perms, **draws,
    )
    return model, new_states, mt, plan


def _assert_step_close(model, new_states, mt, jnew, mj, lr):
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=5e-4, atol=1e-6, err_msg=k)
    assert_params_close(model, jnew.params, atol=lr * 0.05)
    assert_states_close(new_states, jnew.env_states, rtol=1e-5, atol=1e-5)


def test_unfused_train_step_matches_jax():
    """The trainer's unfused path (`rollout_batch` with a fresh reset per
    done, the autograd update on shuffled blocks), with a tight box so that
    episodes end and restart inside the rollout."""
    env_cfg = jcfg.EnvConfig(bb_scale=0.15)
    ppo_kw = dict(k_epochs=2, minibatch_size=64, shuffle_block=8)
    jmodel, jstate, jnew, mj, k_roll, k_upd = _jax_step(env_cfg, ppo_kw, {})
    noise, fresh_x0, (_, jroll, _) = jax_rollout_draws(
        jmodel, jstate.params, jstate.env_states, k_roll, env_cfg, STEPS, reset_pool=0
    )
    assert np.asarray(jroll.dones).sum() > B
    model, new_states, mt, plan = _port_step(jstate, env_cfg, ppo_kw, {}, k_upd,
                                             noise=t(noise), fresh_x0=t(fresh_x0))
    assert plan.branch == "autograd"
    _assert_step_close(model, new_states, mt, jnew, mj, jcfg.PPOConfig().lr)


def test_fused_rollout_and_fused_adam_step_matches_jax():
    """The rollout kernel (JAX's noise and reset pool) and the update with
    the Adam step inside the kernel: `fused_adam` keeps JAX off the fully
    fused branch, so the rollout is made row-major for `ppo_update`."""
    env_cfg = jcfg.EnvConfig()
    ppo_kw = dict(k_epochs=2, minibatch_size=64, shuffle_block=8, fused_update=True,
                  fused_adam=True)
    train_kw = dict(fused_rollout=True)
    _, jstate, jnew, mj, k_roll, k_upd = _jax_step(env_cfg, ppo_kw, train_kw)
    k_noise, k_pool, _ = jax.random.split(k_roll, 3)
    noise = jax.random.normal(k_noise, (STEPS, 4, B))
    pool_keys = jax.random.split(k_pool, (jcfg.TrainConfig().fused_pool, B))
    pool = jax.vmap(jrf.pack_env_state)(
        jax.jit(jax.vmap(jax.vmap(lambda k: jhover.reset(k, env_cfg))))(pool_keys)
    )
    model, new_states, mt, plan = _port_step(jstate, env_cfg, ppo_kw, train_kw, k_upd,
                                             noise=t(noise), pool=t(pool))
    assert plan.branch == "fused_adam"
    _assert_step_close(model, new_states, mt, jnew, mj, jcfg.PPOConfig().lr)


# name -> (PPOConfig fields, TrainConfig fields, branch, update branch)
CONFIGS = {
    "trainer_defaults": (dict(), dict(), "rowmajor", "autograd"),
    "reset_pool": (dict(minibatch_size=32), dict(reset_pool=2), "rowmajor", "autograd"),
    "fused_update": (dict(fused_update=True), dict(), "rowmajor", "fused"),
    "fused_adam": (dict(fused_update=True, fused_adam=True), dict(), "rowmajor", "fused_adam"),
    "clipped": (dict(fused_update=True, fused_adam=True, max_grad_norm=0.5), dict(),
                "rowmajor", "fused"),
    "fused_rollout_only": (dict(), dict(fused_rollout=True), "rowmajor", "autograd"),
    "fused_rollout_tile_0": (dict(fused_update=True, minibatch_size=60),
                             dict(fused_rollout=True), "rowmajor", "autograd"),
    "learned_std": (dict(learn_std=True, fused_update=True), dict(fused_rollout=True),
                    "rowmajor", "autograd"),
    "fully_fused": (dict(fused_update=True, shuffle_block=8), dict(fused_rollout=True),
                    "fused_t", None),
    "short_history": (dict(fused_update=True), dict(fused_rollout=True), "rowmajor", "fused"),
}
ENV = {"short_history": dict(hist_t=4)}  # EnvConfig fields: 60-dim obs, no rollout kernel


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_make_train_step_runs_every_branch_on_the_cpu(name):
    """Every configuration the JAX package trains without randomization and
    with f32 products builds and steps on the CPU, on the branch and update
    branch the JAX gates pick (hidden 32 and tiles of 8, which the card's
    kernels refuse, run through the plain versions here)."""
    ppo_kw, train_kw, branch, update = CONFIGS[name]
    env_cfg = tcfg.EnvConfig(**ENV.get(name, {}))
    pcfg = tcfg.PPOConfig(k_epochs=2, **ppo_kw)
    tc = tcfg.TrainConfig(num_envs=B, rollout_steps=STEPS, network_size=HIDDEN, **train_kw)
    model, opt, state = tppo.ppo_init(0, env_cfg, pcfg, tc, obs_dim=env_cfg.hist_t * 15,
                                      device="cpu")
    assert tppo.train_branch(model, env_cfg, pcfg, tc) == branch
    if update:
        assert tppo.update_plan(pcfg, ROWS, pcfg.learn_std).branch == update
    before = [p.detach().clone() for p in model.parameters()]
    state, metrics = tppo.make_train_step(model, opt, env_cfg, pcfg, tc)(state)
    assert state.update_i == 1
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert all(not torch.equal(a, p) for a, p in zip(before, model.parameters()))


def test_rowmajor_train_loop_equals_sequential_steps():
    env_cfg = tcfg.EnvConfig()
    pcfg = tcfg.PPOConfig(k_epochs=2, minibatch_size=64, fused_update=True, fused_adam=True,
                          shuffle_block=8)
    tc = tcfg.TrainConfig(num_envs=B, rollout_steps=STEPS, network_size=HIDDEN, reset_pool=2)
    m1, o1, s1 = tppo.ppo_init(0, env_cfg, pcfg, tc, device="cpu")
    m2, o2, s2 = tppo.ppo_init(0, env_cfg, pcfg, tc, device="cpu")
    step = tppo.make_train_step(m1, o1, env_cfg, pcfg, tc)
    rows = []
    for _ in range(2):
        s1, met = step(s1)
        rows.append(met)
    s2, stacked = tppo.make_train_loop(m2, o2, env_cfg, pcfg, tc, inner=2)(s2)
    assert s1.update_i == s2.update_i == 2
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    for k, v in stacked.items():
        assert torch.equal(v, torch.stack([r[k] for r in rows])), k
    assert torch.equal(s1.env_states.x, s2.env_states.x)


def test_learned_std_mismatch_is_refused():
    env_cfg = tcfg.EnvConfig()
    tc = tcfg.TrainConfig(num_envs=B, rollout_steps=STEPS, network_size=HIDDEN)
    pcfg = tcfg.PPOConfig(fused_update=True)
    model, opt, _ = tppo.ppo_init(0, env_cfg, pcfg, tc, device="cpu")
    with pytest.raises(ValueError, match="learn_std"):
        tppo.make_train_step(model, opt, env_cfg, dataclasses.replace(pcfg, learn_std=True), tc)
