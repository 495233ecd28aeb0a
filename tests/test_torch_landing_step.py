"""The port's landing env against the JAX package, on the CPU:
`landing_reset` and `landing_step` with the shipped controller and policy,
JAX's own reset draws and per-frame sensor draws injected."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.config import SensorConfig as JSensorConfig
from autonomous_quadrotor_environment_tpu.fixtures import load_solved_controller as jload_ctrl
from autonomous_quadrotor_environment_tpu.landing import env as jenv
from autonomous_quadrotor_environment_tpu.landing import networks as jnet
from autonomous_quadrotor_environment_tpu_torch.config import SensorConfig
from autonomous_quadrotor_environment_tpu_torch.fixtures import (
    LANDING_POLICY,
    load_landing_policy,
    load_solved_controller,
)
from autonomous_quadrotor_environment_tpu_torch.landing import env as tenv
from autonomous_quadrotor_environment_tpu_torch.ops import render_kernel as rk
from autonomous_quadrotor_environment_tpu_torch.utils.checkpoint import load_params
from torch_parity import (  # noqa: F401 (one_torch_thread: the fixture below)
    ATOL,
    RTOL,
    jax_landing_noise,
    jax_landing_reset_draws,
    n,
    one_torch_thread,
)

B = 4
MEAN_ATOL = 1e-5  # the CNN's action tolerance (test_torch_landing.py)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@functools.lru_cache(maxsize=None)
def _jax_policy():
    """The fixture's params as JAX's `load_params` gives them (the port's
    reader; test_torch_landing.py holds the two equal)."""
    return jax.tree.map(jnp.asarray, load_params(LANDING_POLICY))


@functools.lru_cache(maxsize=None)
def _jax_actor():
    return jax.jit(lambda p, img, sens: jnet.LandingActorCritic().apply(
        p, img, sens, method="actor"))


def _cfgs(enabled):
    jc = jenv.LandingConfigs.default(training=False)
    jc = jc._replace(sensor=JSensorConfig(enabled=enabled))
    tc = tenv.LandingConfigs.default(training=False)
    return jc, tc._replace(sensor=SensorConfig(enabled=enabled))


ENV_FIELDS = ("x", "i", "prev_shaping", "has_shaping", "prev_ang", "ang", "ang_vel",
              "abs_sum", "hist", "last_action")
SENS_FIELDS = ("a_b_accel", "a_b_grav", "g_b", "m_b", "a_b_d", "g_b_d", "m_b_d",
               "pos_ins", "vel_ins", "quat_ins", "r_est")
LANDING_FIELDS = ("marker_world", "hist", "crtl_action", "vel_error", "last_shaping",
                  "has_shaping", "internal_frame", "done")


def _assert_landing_close(ps, js, where):
    close = lambda a, b, name: np.testing.assert_allclose(
        n(a).astype(np.float32), np.asarray(b).astype(np.float32), rtol=RTOL, atol=ATOL,
        err_msg=f"{name} {where}")
    for name in ENV_FIELDS:
        close(getattr(ps.env, name), getattr(js.env, name), "env." + name)
    for name in SENS_FIELDS:
        close(getattr(ps.sens, name), getattr(js.sens, name), "sens." + name)
    for name in LANDING_FIELDS:
        close(getattr(ps, name), getattr(js, name), name)


def _assert_images_close(p_img, j_img, where):
    np.testing.assert_allclose(n(p_img), np.asarray(j_img).transpose(0, 3, 1, 2),
                               rtol=RTOL, atol=ATOL, err_msg=f"image {where}")


@pytest.mark.parametrize("enabled,decisions", [(False, 4), (True, 2)])
def test_landing_step_matches_jax(enabled, decisions):
    """B=4 episodes from JAX's reset draws, with the shipped controller and
    policy: the port's policy picks each action from the port's image and
    both envs take it. State and images within rtol 2e-4, atol 2e-5, the
    reward within atol 1e-4; done and solved equal. With sensors on, JAX's
    per-frame draws are injected."""
    jcfgs, tcfgs = _cfgs(enabled)
    cm, cp = jload_ctrl()
    jparams = _jax_policy()
    ctrl = load_solved_controller(device="cpu")
    policy = load_landing_policy(device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(3), B)

    js, jobs = jax.jit(jax.vmap(lambda k: jenv.landing_reset(k, jcfgs, cm, cp)))(keys)
    draws, state_keys = jax_landing_reset_draws(keys)
    noise, state_keys = jax_landing_noise(state_keys, tcfgs.landing.task_interval)
    before = rk.render_nadir_batch.launches
    ps, pobs = tenv.landing_reset(None, tcfgs, ctrl, draws=draws, noise=noise)
    _assert_landing_close(ps, js, "after reset")
    _assert_images_close(pobs.image, jobs.image, "after reset")
    np.testing.assert_array_equal(np.asarray(js.key), state_keys)

    step = jax.jit(jax.vmap(lambda s, a: jenv.landing_step(s, a, jcfgs, cm, cp)))
    for d in range(decisions):
        with torch.no_grad():
            action = policy.actor(pobs.image, pobs.control_in)
        jaction = _jax_actor()(jparams, jobs.image, jobs.control_in)
        np.testing.assert_allclose(n(action), np.asarray(jaction), atol=MEAN_ATOL, rtol=0)
        js, jout = step(js, jnp.asarray(n(action)))
        noise, state_keys = jax_landing_noise(state_keys, tcfgs.landing.task_interval)
        ps, pout = tenv.landing_step(ps, action, tcfgs, ctrl, noise=noise)
        _assert_landing_close(ps, js, f"after decision {d}")
        _assert_images_close(pout.obs.image, jout.obs.image, f"after decision {d}")
        np.testing.assert_allclose(n(pout.reward), np.asarray(jout.reward), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(n(pout.done), np.asarray(jout.done))
        np.testing.assert_array_equal(n(pout.solved), np.asarray(jout.solved))
        pobs, jobs = pout.obs, jout.obs
    assert rk.render_nadir_batch.launches == before  # the CPU takes the plain version
    assert int(ps.internal_frame[0]) == (decisions + 1) * tcfgs.landing.task_interval


def test_landing_step_draws_from_a_generator():
    _, tcfgs = _cfgs(True)
    ctrl = load_solved_controller(device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, obs = tenv.landing_reset(gen, tcfgs, ctrl, 3)
    assert obs.image.shape == (3, 3, 84, 84) and obs.control_in.shape == (3, 75)
    state2, out = tenv.landing_step(state, torch.zeros(3, 3), tcfgs, ctrl, gen)
    for v in (out.obs.image, out.reward, state2.env.x, state2.sens.pos_ins):
        assert torch.isfinite(v).all()
    assert out.done.dtype == torch.bool and out.reward.shape == (3,)
    # The zero action commands the default descent of 2/3 m/s.
    torch.testing.assert_close(state2.vel_error[:, 2], torch.full((3,), -1.0 / 1.5))
    assert dataclasses.is_dataclass(state2)
