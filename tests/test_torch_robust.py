"""The port's robust env against the JAX package's, on the CPU: domain
sampling and the wind model, the randomized hover env, and the robust
`rollout_batch` (per-step resets and a reset pool). Every draw is the JAX
package's own, walked down its per-env key chains (`torch_parity`).

Tolerances: `sample_domain` and `wind_update` to 1e-6; the env at the
step-math tolerance of tests/test_rollout_fused.py (rtol 2e-4, atol 2e-5);
the rollout as tests/test_torch_rollout.py holds it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu import config as jcfg
from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.core import randomization as jrand
from autonomous_quadrotor_environment_tpu.envs import hover as jhover
from autonomous_quadrotor_environment_tpu_torch import config as tcfg
from autonomous_quadrotor_environment_tpu_torch.agents import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
from autonomous_quadrotor_environment_tpu_torch.core import randomization as trand
from autonomous_quadrotor_environment_tpu_torch.envs import hover as thover
from torch_parity import (
    DOM_FIELDS,
    assert_states_close,
    jax_domain_draws,
    jax_reset_draws,
    jax_robust_rollout_draws,
    jax_step_gusts,
    n,
    one_torch_thread,  # noqa: F401  (the module's fixture)
    port_dom,
    port_env_config,
    port_states,
    t,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B = 16
WINDY = jcfg.RandomizationConfig(enabled=True)

# name -> the JAX RandomizationConfig sampled
DOMAINS = {
    "enabled": WINDY,
    "disabled": jcfg.RandomizationConfig(),
    "severity_sample": dataclasses.replace(WINDY, severity_sample=True),
    "scaled_0": WINDY.scaled(0.0),
    "scaled_half": dataclasses.replace(WINDY, severity_sample=True).scaled(0.5),
}


@pytest.mark.parametrize("name", sorted(DOMAINS))
def test_sample_domain_matches_jax(name):
    """`sample_domain` from JAX's own draws (its split of each env's key),
    and the config's `scaled`, against the JAX package's, to 1e-6."""
    jc = DOMAINS[name]
    pc = tcfg.RandomizationConfig(**dataclasses.asdict(jc))
    assert dataclasses.asdict(pc.scaled(0.3)) == dataclasses.asdict(jc.scaled(0.3))
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    jd = jax.vmap(lambda k: jrand.sample_domain(k, jc))(keys)
    td = trand.sample_domain(pc, B, draws=jax_domain_draws(keys, jc.severity_sample))
    for f in DOM_FIELDS:
        np.testing.assert_allclose(n(getattr(td, f)), np.asarray(getattr(jd, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    if jc.enabled:
        assert float(np.abs(np.asarray(jd.mass_factor)).max()) > 0
        assert np.abs(n(td.mass_factor)).max() <= np.float32(2 * jc.d_m)  # clipped at 2 sigma
    # From a generator: the same shapes, seeded.
    g1 = trand.sample_domain(pc, B, torch.Generator().manual_seed(1))
    g2 = trand.sample_domain(pc, B, torch.Generator().manual_seed(1))
    for f in DOM_FIELDS:
        assert getattr(g1, f).shape == getattr(td, f).shape
        assert torch.equal(getattr(g1, f), getattr(g2, f))


def test_wind_update_matches_jax_over_two_gust_periods():
    """45 steps at gust_period 20 (resamples at i = 1, 21, 41), each env's
    gust draw from its own key, severity-sampled domains: the gust state
    and the wind agree to 1e-6 at every step."""
    jc = dataclasses.replace(WINDY, gust_period=20, severity_sample=True)
    pc = tcfg.RandomizationConfig(**dataclasses.asdict(jc))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jd = jax.vmap(lambda k: jrand.sample_domain(k, jc))(keys)
    td = port_dom(jd)
    step_keys = jax.random.split(jax.random.PRNGKey(4), B)
    jupdate = jax.jit(jax.vmap(lambda d, k, i: jrand.wind_update(d, k, i, jc),
                               in_axes=(0, 0, None)))
    for i in range(1, 46):
        k_wind = jax.vmap(lambda k: jax.random.split(k)[1])(step_keys)
        eps, step_keys = jax_step_gusts(step_keys, 1)
        jd, jwind = jupdate(jd, k_wind, jnp.int32(i))
        td, twind = trand.wind_update(td, t(eps[0]), torch.full((B,), i, dtype=torch.int32), pc)
        np.testing.assert_allclose(n(twind), np.asarray(jwind), rtol=1e-6, atol=1e-6)
        for f in ("gust_last", "gust_next"):
            np.testing.assert_allclose(n(getattr(td, f)), np.asarray(getattr(jd, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{f} at i={i}")


ENV = jcfg.EnvConfig(randomization=dataclasses.replace(WINDY, gust_period=20))


def test_randomized_reset_and_step_match_jax():
    """`hover.reset` from JAX's draws (domains, initial states, the warmup's
    gusts, of which i = 1 resamples) and 60 `hover.step`s near hover with
    each step's gust from the env's key chain (resamples at i = 21, 41, 61),
    at rtol 2e-4 / atol 2e-5, the domain's fields too."""
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    js = jax.jit(jax.vmap(lambda k: jhover.reset(k, ENV)))(keys)
    x0, dom, warm_gust, k_after = jax_reset_draws(keys, ENV)
    np.testing.assert_array_equal(k_after, np.asarray(js.key))
    pc = port_env_config(ENV)
    ts = thover.reset(None, pc, det_state=t(x0), dom_draws=dom, warmup_gust=t(warm_gust))
    assert_states_close(ts, js)
    assert float(np.abs(np.asarray(js.dom.gust_next)).max()) > 0

    rng = np.random.RandomState(0)
    jstep = jax.jit(jax.vmap(lambda s, a: jhover.step(s, a, ENV)))
    zc = np.asarray(jhover.zero_control(ENV))
    for i in range(60):
        action = (zc + rng.normal(0, 0.05, (B, 4))).astype(np.float32)
        eps, _ = jax_step_gusts(js.key, 1)
        js, jout = jstep(js, action)
        ts, tout = thover.step(ts, t(action), pc, gust_eps=t(eps[0]))
        np.testing.assert_array_equal(n(tout.done), np.asarray(jout.done))
        np.testing.assert_allclose(n(tout.reward), np.asarray(jout.reward), rtol=2e-4, atol=2e-5)
    assert_states_close(ts, js)
    assert int(ts.i[0]) == ENV.warmup + 60


def test_randomized_reset_without_its_draws_is_refused():
    pc = port_env_config(ENV)
    with pytest.raises(ValueError, match="generator"):
        thover.reset(None, pc, det_state=torch.zeros(2, 13))
    ts = thover.reset(torch.Generator().manual_seed(0), pc, n=2)
    with pytest.raises(ValueError, match="generator"):
        thover.step(ts, torch.zeros(2, 4), pc)


ROLL_ENV = jcfg.EnvConfig(bb_scale=0.15, randomization=dataclasses.replace(WINDY, gust_period=7))
HIDDEN, STEPS = 32, 8


@pytest.mark.parametrize("reset_pool", [0, 2])
def test_robust_rollout_batch_matches_jax(reset_pool):
    """The robust `rollout_batch` with JAX's noise, fresh episodes (their
    domains and warmup gusts) and every step's gust draw, through each env's
    key chain and JAX's own done flags (gust_period 7: resamples inside the
    rollout), at tests/test_torch_rollout.py's tolerances."""
    jmodel = JActorCritic(hidden=HIDDEN)
    jparams = jmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, 75)))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    js = jax.jit(jax.vmap(lambda k: jhover.reset(k, ROLL_ENV)))(keys)
    draws, (jnew, jroll, jboot) = jax_robust_rollout_draws(
        jmodel, jparams, js, jax.random.PRNGKey(4), ROLL_ENV, STEPS, reset_pool)
    dones = np.asarray(jroll.dones)
    assert dones.sum() > B  # episodes end and restart within the rollout

    model = ActorCritic.from_flax(jax.tree.map(np.asarray, jparams))
    pnew, roll, boot = tppo.rollout_batch(
        model, port_states(js), None, port_env_config(ROLL_ENV), STEPS, reset_pool=reset_pool,
        **draws,
    )
    np.testing.assert_array_equal(n(roll.dones), dones)
    np.testing.assert_array_equal(n(roll.solved), np.asarray(jroll.solved))
    for name, tol in (("obs", 1e-6), ("actions", 1e-6), ("logprobs", 1e-6), ("values", 1e-6),
                      ("rewards", 1e-5)):
        np.testing.assert_allclose(n(getattr(roll, name)), np.asarray(getattr(jroll, name)),
                                   rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_allclose(n(boot), np.asarray(jboot), rtol=1e-6, atol=1e-6)
    assert_states_close(pnew, jnew, rtol=1e-5, atol=1e-5)


