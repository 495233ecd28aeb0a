"""The port's fully fused PPO train step against the JAX package's, on the
CPU: one whole step from the same state with JAX's draws injected, the train
loop against sequential steps, the branches that are refused, and
`make_eval_fn` on JAX's reset states.

Tolerances: updated parameters within atol lr * 0.05 and metrics within
rtol 5e-4, those of the JAX package's own fully-fused-vs-materialized test
(tests/test_ops_t.py:140-147); the rest as stated per test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu import config as jcfg
from autonomous_quadrotor_environment_tpu.agents import make_eval_fn as jmake_eval_fn
from autonomous_quadrotor_environment_tpu.agents import make_train_step as jmake_train_step
from autonomous_quadrotor_environment_tpu.agents import ppo_init as jppo_init
from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.envs import hover as jhover
from autonomous_quadrotor_environment_tpu.fixtures import load_solved_controller as jload_solved
from autonomous_quadrotor_environment_tpu.ops import rollout_fused as jrf
from autonomous_quadrotor_environment_tpu_torch import config as tcfg
from autonomous_quadrotor_environment_tpu_torch.agents import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
from autonomous_quadrotor_environment_tpu_torch.fixtures import load_solved_controller
from torch_parity import (
    assert_params_close,
    assert_states_close,
    jax_perms,
    port_env_config,
    port_states,
    t,
)

STEPS, B, HIDDEN = 8, 16, 32
PPO = dict(k_epochs=3, minibatch_size=64, fused_update=True, shuffle_block=8)


def test_train_step_matches_jax():
    """One whole fully fused train step from the same state: JAX's noise,
    reset pool and per-epoch permutations, drawn from the keys its step
    splits, are fed to the port's `train_step_from_inputs`."""
    env_cfg = jcfg.EnvConfig()
    minibatch = 64
    ppo_kw = dict(PPO, k_epochs=2, minibatch_size=minibatch)
    jppo = jcfg.PPOConfig(**ppo_kw)
    jtrain = jcfg.TrainConfig(num_envs=B, rollout_steps=STEPS, network_size=HIDDEN,
                              fused_rollout=True)
    jmodel, tx, jstate = jppo_init(jax.random.PRNGKey(0), env_cfg, jppo, jtrain)
    jstep = jax.jit(jmake_train_step(jmodel, tx, env_cfg, jppo, jtrain))
    jnew, mj = jstep(jstate)

    # The draws of JAX's train_step and rollout_batch_fused_raw.
    _, k_roll, k_upd = jax.random.split(jstate.key, 3)
    k_noise, k_pool, _ = jax.random.split(k_roll, 3)
    noise = jax.random.normal(k_noise, (STEPS, 4, B))
    pool_keys = jax.random.split(k_pool, (jtrain.fused_pool, B))
    pool_states = jax.jit(jax.vmap(jax.vmap(lambda k: jhover.reset(k, env_cfg))))(pool_keys)
    pool = jax.vmap(jrf.pack_env_state)(pool_states)
    n_rows = STEPS * B
    tile = 8
    perms = jax_perms(k_upd, jppo.k_epochs, n_rows // tile, n_rows // minibatch)

    model = ActorCritic.from_flax(jax.tree.map(np.asarray, jstate.params))
    pcfg = tcfg.PPOConfig(**ppo_kw)
    opt = tppo.make_optimizer(model, pcfg)
    new_states, mt = tppo.train_step_from_inputs(
        model, opt, port_states(jstate.env_states), t(noise), t(pool),
        port_env_config(env_cfg), pcfg, perms=torch.from_numpy(perms),
    )
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=5e-4, atol=1e-6, err_msg=k)
    assert_params_close(model, jnew.params, atol=jppo.lr * 0.05)
    assert_states_close(new_states, jnew.env_states)


def test_train_loop_equals_sequential_steps():
    env_cfg = tcfg.EnvConfig()
    pcfg = tcfg.PPOConfig(**dict(PPO, k_epochs=2))
    tc = tcfg.TrainConfig(num_envs=B, rollout_steps=STEPS, network_size=HIDDEN,
                          fused_rollout=True)
    m1, o1, s1 = tppo.ppo_init(0, env_cfg, pcfg, tc, device="cpu")
    m2, o2, s2 = tppo.ppo_init(0, env_cfg, pcfg, tc, device="cpu")
    step = tppo.make_train_step(m1, o1, env_cfg, pcfg, tc)
    rows = []
    for _ in range(2):
        s1, met = step(s1)
        rows.append(met)
    loop = tppo.make_train_loop(m2, o2, env_cfg, pcfg, tc, inner=2)
    s2, stacked = loop(s2)
    assert s1.update_i == s2.update_i == 2
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    for k, v in stacked.items():
        assert v.shape == (2,)
        assert torch.equal(v, torch.stack([r[k] for r in rows])), k
    assert torch.equal(s1.env_states.x, s2.env_states.x)


def test_make_train_step_refuses_what_is_not_ported():
    """Nothing the JAX package sends to a kernel is refused on the CPU any
    more: bf16 products build and step on both branches (ported since, like
    randomization, which takes the row-major branch and steps), at any
    width and tile; a state of another model, and a model whose std
    disagrees with the config, are refused as in the JAX package."""
    env_cfg = tcfg.EnvConfig()
    tc = tcfg.TrainConfig(num_envs=B, rollout_steps=STEPS, network_size=HIDDEN,
                          fused_rollout=True)
    pcfg = tcfg.PPOConfig(**PPO)
    model, opt, _ = tppo.ppo_init(0, env_cfg, pcfg, tc, device="cpu")
    step = tppo.make_train_step(model, opt, env_cfg, pcfg, tc)  # the fused branch
    _, _, other = tppo.ppo_init(1, env_cfg, pcfg, tc, device="cpu")
    with pytest.raises(ValueError, match="state.model"):
        step(other)  # a state of another model is refused, not trained
    robust = dataclasses.replace(
        env_cfg, randomization=dataclasses.replace(env_cfg.randomization, enabled=True)
    )
    assert tppo.train_branch(model, robust, pcfg, tc) == "rowmajor"
    _, _, robust_state = tppo.ppo_init(0, robust, pcfg, tc, device="cpu")
    assert robust_state.env_states.dom.mass_factor.abs().max() > 0
    robust_state = dataclasses.replace(robust_state, model=model, optimizer=opt)
    robust_state, metrics = tppo.make_train_step(model, opt, robust, pcfg, tc)(robust_state)
    assert robust_state.update_i == 1
    assert all(torch.isfinite(v).all() for v in metrics.values())
    for p, tcc, branch in [(dataclasses.replace(pcfg, fused_compute="bf16"), tc, "fused_t"),
                           (dataclasses.replace(pcfg, fused_compute="bf16", fused_adam=True),
                            dataclasses.replace(tc, fused_rollout=False), "rowmajor")]:
        assert tppo.train_branch(model, env_cfg, p, tcc) == branch
        m_b, o_b, s_b = tppo.ppo_init(0, env_cfg, p, tcc, device="cpu")
        before = [x.detach().clone() for x in m_b.parameters()]
        s_b, met_b = tppo.make_train_step(m_b, o_b, env_cfg, p, tcc)(s_b)
        assert s_b.update_i == 1 and all(torch.isfinite(v).all() for v in met_b.values())
        assert not all(torch.equal(a, b) for a, b in zip(before, m_b.parameters()))
    # bf16 products matter only inside a kernel: the autograd branch runs.
    tppo.make_train_step(model, opt, env_cfg,
                         dataclasses.replace(pcfg, fused_compute="bf16", fused_update=False),
                         dataclasses.replace(tc, fused_rollout=False))
    # Formerly refused, now ported: the unfused rollout and update, the
    # block-1 fallback, the Adam step in the kernel and a learned std.
    for p, tcc in [(pcfg, dataclasses.replace(tc, fused_rollout=False)),
                   (dataclasses.replace(pcfg, fused_update=False), tc),
                   (dataclasses.replace(pcfg, minibatch_size=60), tc),
                   (dataclasses.replace(pcfg, fused_adam=True), tc)]:
        tppo.make_train_step(model, opt, env_cfg, p, tcc)
    learned = dataclasses.replace(pcfg, learn_std=True)
    m2, o2, _ = tppo.ppo_init(0, env_cfg, learned, tc, device="cpu")
    assert m2.learn_std and m2.log_std.dtype == torch.float32
    tppo.make_train_step(m2, o2, env_cfg, learned, tc)
    with pytest.raises(ValueError, match="action_std"):
        tppo.make_train_step(model, opt, env_cfg, dataclasses.replace(pcfg, action_std=0.2), tc)
    with pytest.raises(ValueError, match="learn_std"):
        tppo.make_train_step(model, opt, env_cfg, learned, tc)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tppo.ppo_init(0, env_cfg, pcfg, tc)


@pytest.mark.parametrize("which", ["solved", "untrained"])
def test_eval_fn_matches_jax(which):
    """`make_eval_fn` on JAX's reset states: the solved fixture flies
    stably, so every metric agrees within 1e-4 (abs and rel; last-bit
    differences of the products over 300 steps) and the discrete ones
    exactly; the untrained net crashes early."""
    env_cfg = jcfg.EnvConfig()
    episodes, max_steps = 16, 300
    if which == "solved":
        jmodel, jparams = jload_solved()
        model = load_solved_controller(device="cpu")
    else:
        jmodel = JActorCritic(hidden=HIDDEN)
        jparams = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 75)))
        model = ActorCritic.from_flax(jax.tree.map(np.asarray, jparams))
    key = jax.random.PRNGKey(5)
    mj = jax.jit(jmake_eval_fn(jmodel, env_cfg, episodes, max_steps))(jparams, key)
    js = jax.jit(jax.vmap(lambda k: jhover.reset(k, env_cfg)))(jax.random.split(key, episodes))
    mt = tppo.make_eval_fn(model, port_env_config(env_cfg), episodes, max_steps)(
        env_states=port_states(js)
    )
    assert set(mt) == set(mj)
    for k in ("eval_solved", "eval_survived", "eval_length", "eval_station_keeping"):
        assert float(mt[k]) == float(mj[k]), k
    for k in ("eval_reward", "eval_rms_vel_late"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    if which == "untrained":
        assert float(mt["eval_length"]) < max_steps - env_cfg.warmup


def test_evaluate_draws_its_own_episodes():
    model = load_solved_controller(device="cpu")
    out = tppo.evaluate(model, tcfg.EnvConfig(), 4, torch.Generator().manual_seed(0))
    assert set(out) >= {"eval_reward", "eval_solved", "eval_length"}
    assert all(isinstance(v, float) and np.isfinite(v) for v in out.values())
