"""The port's featurizer, reward and hover env against the JAX package's
(B=16, CPU). Initial states come from the JAX package's `hover.reset` and
are injected into the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu import config as jcfg
from autonomous_quadrotor_environment_tpu.envs import featurizer as jfeat
from autonomous_quadrotor_environment_tpu.envs import hover as jhover
from autonomous_quadrotor_environment_tpu.envs import rewards as jrew
from autonomous_quadrotor_environment_tpu_torch import config as tcfg
from autonomous_quadrotor_environment_tpu_torch.envs import featurizer as tfeat
from autonomous_quadrotor_environment_tpu_torch.envs import hover as thover
from autonomous_quadrotor_environment_tpu_torch.envs import rewards as trew
from torch_parity import ATOL, RTOL, assert_states_close, n, port_env_config, port_states, t

B = 16

CONFIGS = {
    "default": jcfg.EnvConfig(),
    "tight_box": dataclasses.replace(jcfg.EnvConfig(), bb_scale=0.3),
    "velocity_task": dataclasses.replace(jcfg.EnvConfig(), vel_target_max=(1.0, 0.5, 0.8)),
    "landing_variant": jcfg.EnvConfig.landing_variant(),
    "eval_mode_substeps": dataclasses.replace(jcfg.EnvConfig(), training=False, rk_substeps=2),
}


def test_featurizer_matches_jax():
    rng = np.random.RandomState(0)
    hist = rng.normal(size=(B, 75)).astype(np.float32)
    qs = rng.normal(size=(B, 14)).astype(np.float32)
    act = rng.normal(size=(B, 4)).astype(np.float32)
    want = jax.vmap(jfeat.push_hist)(jnp.asarray(hist), jnp.asarray(qs), jnp.asarray(act))
    got = tfeat.push_hist(t(hist), t(qs), t(act))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert tfeat.init_hist(B, 5).shape == (B, tfeat.feat_size(5)) == (B, 75)
    assert not tfeat.init_hist(B, 5).any()


@pytest.mark.parametrize("variant", ["primary", "opt"])
def test_hover_reward_matches_jax(variant):
    jr = jcfg.RewardConfig() if variant == "primary" else jcfg.RewardConfig.opt_variant()
    tr = tcfg.RewardConfig(**dataclasses.asdict(jr))
    rng = np.random.RandomState(1)
    # Scales spanning the cascade thresholds, the solve test and the box.
    scale = np.repeat(np.array([1e-3, 4e-3, 3e-2, 0.3])[:, None], B // 4, axis=0)
    vel = (rng.normal(size=(B, 3)) * scale).astype(np.float32)
    ang = (rng.normal(size=(B, 3)) * scale).astype(np.float32)
    ang_vel = (rng.normal(size=(B, 3)) * scale).astype(np.float32)
    action = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
    prev = rng.normal(size=(B,)).astype(np.float32)
    has_prev = rng.uniform(size=(B,)) > 0.3
    step_i = rng.randint(990, 1010, (B,)).astype(np.int32)
    bb_done = rng.uniform(size=(B,)) > 0.8
    zc = np.zeros(4, np.float32)
    for training in (True, False):
        want = jax.vmap(
            lambda v, a, w, ac, p, h, i, d: jrew.hover_reward(
                jr, vel=v, ang=a, ang_vel=w, action=ac, zero_control=jnp.asarray(zc),
                prev_shaping=p, has_prev=h, step_i=i, max_steps=1005, bb_done=d,
                training=training,
            )
        )(*[jnp.asarray(x) for x in (vel, ang, ang_vel, action, prev, has_prev, step_i, bb_done)])
        got = trew.hover_reward(
            tr, vel=t(vel), ang=t(ang), ang_vel=t(ang_vel), action=t(action),
            zero_control=t(zc), prev_shaping=t(prev), has_prev=t(has_prev),
            step_i=t(step_i), max_steps=1005, bb_done=t(bb_done), training=training,
        )
        for name in ("reward", "shaping"):
            np.testing.assert_allclose(
                n(getattr(got, name)), np.asarray(getattr(want, name)),
                rtol=RTOL, atol=ATOL, err_msg=name,
            )
        for name in ("solved", "done"):
            np.testing.assert_array_equal(n(getattr(got, name)), np.asarray(getattr(want, name)))


def _jax_reset(jc, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return jax.jit(jax.vmap(lambda k: jhover.reset(k, jc)))(keys)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_hover_step_matches_jax(name):
    jc = CONFIGS[name]
    tc = port_env_config(jc)
    js = _jax_reset(jc)
    ts = port_states(js)
    jstep = jax.jit(jax.vmap(lambda s, a: jhover.step(s, a, jc)))
    rng = np.random.RandomState(2)
    for _ in range(6):
        a = rng.uniform(-1.2, 1.2, (B, 4)).astype(np.float32)
        js, jo = jstep(js, jnp.asarray(a))
        ts, to = thover.step(ts, t(a), tc)
        assert_states_close(ts, js)
        np.testing.assert_allclose(n(to.reward), np.asarray(jo.reward), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(n(to.obs), np.asarray(jo.obs), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            n(to.quat_state), np.asarray(jo.quat_state), rtol=RTOL, atol=ATOL
        )
        np.testing.assert_array_equal(n(to.done), np.asarray(jo.done))
        np.testing.assert_array_equal(n(to.solved), np.asarray(jo.solved))


@pytest.mark.parametrize("name", ["default", "landing_variant", "velocity_task"])
def test_reset_with_det_state_matches_jax(name):
    """The warmup of `reset` from injected initial states; for the velocity
    task the target is drawn by each side's own generator, so it is copied
    across before comparing."""
    jc = CONFIGS[name]
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    x0 = jax.vmap(jhover.random_initial_state)(keys)
    js = jax.jit(jax.vmap(lambda k, x: jhover.reset(k, jc, det_state=x)))(keys, x0)
    ts = thover.reset(torch.Generator().manual_seed(0), port_env_config(jc), det_state=t(x0))
    if jc.has_vel_target:
        assert ts.vel_target.abs().max() > 0
        assert (ts.vel_target.abs() <= torch.tensor(jc.vel_target_max)).all()
        # Re-run the port's warmup with the JAX targets for a like-for-like check.
        raw = thover._raw_state(t(x0), jc.hist_t, t(js.vel_target))
        zc = thover.zero_control(port_env_config(jc)).expand(B, 4)
        for _ in range(jc.warmup):
            raw, _ = thover.step(raw, zc, port_env_config(jc))
        ts = raw.replace(done=torch.zeros_like(raw.done), solved=torch.zeros_like(raw.solved))
    assert_states_close(ts, js)
    assert int(ts.i[0]) == jc.warmup and not ts.done.any() and not ts.solved.any()


def test_random_initial_state_distribution():
    x = thover.random_initial_state(torch.Generator().manual_seed(1), 4096)
    assert x.shape == (4096, 13) and x.dtype == torch.float32
    q = x[:, 6:10]
    np.testing.assert_allclose(n(q.norm(dim=-1)), 1.0, atol=1e-6)
    ang = thover.quat_euler(q)
    assert ang.abs().max() <= 0.5 + 1e-5
    assert x[:, 0:5:2].abs().max() <= tcfg.BB_POS / 2
    assert x[:, 1:6:2].abs().max() <= tcfg.BB_VEL / 2
    assert x[:, 10:13].min() >= -tcfg.BB_VEL * 1.5 and x[:, 10:13].max() <= tcfg.BB_POS * 1.5
    # Seeded: the same generator seed gives the same states.
    again = thover.random_initial_state(torch.Generator().manual_seed(1), 4096)
    assert torch.equal(x, again)


def test_randomization_is_refused():
    """Randomization is ported: a randomized reset and step run from a
    generator, and are refused only where they have neither their draws nor
    a generator to draw them from."""
    cfg = tcfg.EnvConfig(randomization=tcfg.RandomizationConfig(enabled=True))
    with pytest.raises(ValueError, match="generator"):
        thover.reset(None, cfg, det_state=torch.zeros(2, 13))
    gen = torch.Generator().manual_seed(0)
    s = thover.reset(gen, cfg, n=2)
    assert s.dom.mass_factor.abs().max() > 0 and s.dom.gust_next.abs().max() > 0
    with pytest.raises(ValueError, match="generator"):
        thover.step(s, thover.zero_control(cfg).expand(2, 4), cfg)
    s2, out = thover.step(s, thover.zero_control(cfg).expand(2, 4), cfg, gen=gen)
    assert torch.isfinite(s2.x).all() and torch.isfinite(out.reward).all()
