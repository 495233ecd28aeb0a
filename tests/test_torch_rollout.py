"""The port's step-by-step rollout against the JAX package's, on the CPU:
`hover.step_autoreset` and `agents.ppo.rollout_batch` with and without a
reset pool, each given the JAX package's action noise and fresh episodes.

Tolerances: observations and the policy's outputs within 1e-6, rewards and
states within 1e-5 (abs and rel; the split of tests/test_torch_envs.py: the
Euler-rate rows scale last-bit angle differences by 1/dt), done flags
equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu import config as jcfg
from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.envs import hover as jhover
from autonomous_quadrotor_environment_tpu_torch.agents import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
from autonomous_quadrotor_environment_tpu_torch.envs import hover as thover
from torch_parity import (
    assert_states_close,
    jax_rollout_draws,
    n,
    port_env_config,
    port_states,
    t,
)

B, HIDDEN, STEPS = 16, 32, 8
# A tight box ends episodes within a few steps, so the reset path runs.
ENV = jcfg.EnvConfig(bb_scale=0.15)


def _jax_states(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return jax.jit(jax.vmap(lambda k: jhover.reset(k, ENV)))(keys)


def test_step_autoreset_matches_jax():
    """One step of half-crashing envs: the terminal transition is reported
    and the done envs carry the fresh episode, JAX's own fresh resets."""
    js = _jax_states(0)
    action = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (B, 4), minval=-1.0, maxval=1.0))
    jnew, jout = jax.jit(jax.vmap(lambda s, a: jhover.step_autoreset(s, a, ENV)))(js, action)
    # JAX's fresh episodes: reset(k_reset) with k_reset split from the
    # stepped key, as step_autoreset draws it.
    k_reset = jax.vmap(lambda k: jax.random.split(jax.random.split(k)[0])[1])(js.key)
    fresh = jax.jit(jax.vmap(lambda k: jhover.reset(k, ENV)))(k_reset)
    done = np.asarray(jout.done)
    assert 0 < done.sum() < B

    pnew, pout = thover.step_autoreset(port_states(js), t(action), port_env_config(ENV),
                                       fresh=port_states(fresh))
    np.testing.assert_array_equal(n(pout.done), done)
    np.testing.assert_array_equal(n(pout.solved), np.asarray(jout.solved))
    np.testing.assert_allclose(n(pout.obs), np.asarray(jout.obs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(pout.reward), np.asarray(jout.reward), rtol=1e-5, atol=1e-5)
    assert_states_close(pnew, jnew, rtol=1e-5, atol=1e-5)
    # The done envs restart: step counter at the warmup, fresh window.
    np.testing.assert_array_equal(n(pnew.i)[done], ENV.warmup)


@pytest.mark.parametrize("reset_pool", [0, 2])
def test_rollout_batch_matches_jax(reset_pool):
    """`rollout_batch` with JAX's noise and fresh episodes (per-step resets
    through each env's key chain, or the P x B pool) against the JAX
    package's `rollout_batch`."""
    jmodel = JActorCritic(hidden=HIDDEN)
    jparams = jmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, 75)))
    js = _jax_states(3)
    key = jax.random.PRNGKey(4)
    noise, fresh_x0, (jnew, jroll, jboot) = jax_rollout_draws(
        jmodel, jparams, js, key, ENV, STEPS, reset_pool
    )
    dones = np.asarray(jroll.dones)
    assert dones.sum() > B  # episodes end and restart within the rollout

    model = ActorCritic.from_flax(jax.tree.map(np.asarray, jparams))
    pnew, roll, boot = tppo.rollout_batch(
        model, port_states(js), None, port_env_config(ENV), STEPS, reset_pool=reset_pool,
        noise=t(noise), fresh_x0=t(fresh_x0),
    )
    np.testing.assert_array_equal(n(roll.dones), dones)
    np.testing.assert_array_equal(n(roll.solved), np.asarray(jroll.solved))
    for name, tol in (("obs", 1e-6), ("actions", 1e-6), ("logprobs", 1e-6), ("values", 1e-6),
                      ("rewards", 1e-5)):
        np.testing.assert_allclose(n(getattr(roll, name)), np.asarray(getattr(jroll, name)),
                                   rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_allclose(n(boot), np.asarray(jboot), rtol=1e-6, atol=1e-6)
    assert_states_close(pnew, jnew, rtol=1e-5, atol=1e-5)


def test_rollout_batch_draws_from_the_generator():
    """Without injected draws the rollout takes noise and fresh episodes
    from ``gen``: the same seed gives the same rollout, the pool wraps
    around per env, and the step count of a finished env restarts."""
    cfg = port_env_config(ENV)
    torch.manual_seed(0)
    model = ActorCritic(hidden=HIDDEN)
    states = thover.reset(torch.Generator().manual_seed(1), cfg, n=B)
    outs = [tppo.rollout_batch(model, states, torch.Generator().manual_seed(2), cfg, STEPS,
                               reset_pool=1) for _ in range(2)]
    assert torch.equal(outs[0][1].obs, outs[1][1].obs)
    assert torch.equal(outs[0][0].x, outs[1][0].x)
    roll = outs[0][1]
    assert roll.obs.shape == (STEPS, B, 75) and roll.logprobs.shape == (STEPS, B, 4)
    assert roll.dones.sum(0).max() > 1  # an env used its one pool entry twice
    done_last = roll.dones[-1]
    assert (outs[0][0].i[done_last] == cfg.warmup).all()


def test_rollout_batch_with_a_learned_std_samples_with_it():
    cfg = port_env_config(dataclasses.replace(ENV, bb_scale=1.0))
    model = ActorCritic(hidden=HIDDEN, learn_std=True, action_std=0.1)
    with torch.no_grad():
        model.log_std.fill_(np.log(0.3))
    states = thover.reset(torch.Generator().manual_seed(5), cfg, n=B)
    noise = torch.randn(STEPS, B, 4, generator=torch.Generator().manual_seed(6))
    _, roll, _ = tppo.rollout_batch(model, states, torch.Generator().manual_seed(7), cfg, STEPS,
                                    noise=noise)
    with torch.no_grad():
        mean = model.actor_mean(roll.obs[0])
    torch.testing.assert_close(roll.actions[0], mean + 0.3 * noise[0], rtol=1e-5, atol=1e-6)
    want = -0.5 * noise[0] ** 2 - np.log(0.3) - 0.5 * np.log(2 * np.pi)
    torch.testing.assert_close(roll.logprobs[0], want, rtol=1e-5, atol=1e-5)
