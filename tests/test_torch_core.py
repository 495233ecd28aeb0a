"""The port's config copy, quaternion utilities and dynamics against the JAX
package's, on the same numpy-made inputs (B=16, CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu import config as jcfg
from autonomous_quadrotor_environment_tpu.core import dynamics as jdyn
from autonomous_quadrotor_environment_tpu.core import quaternion as jq
from autonomous_quadrotor_environment_tpu.core.randomization import DomainParams as JDom
from autonomous_quadrotor_environment_tpu.core.randomization import zeros_domain as jzeros
from autonomous_quadrotor_environment_tpu_torch import config as tcfg
from autonomous_quadrotor_environment_tpu_torch.core import dynamics as tdyn
from autonomous_quadrotor_environment_tpu_torch.core import quaternion as tq
from autonomous_quadrotor_environment_tpu_torch.core.randomization import DomainParams as TDom
from autonomous_quadrotor_environment_tpu_torch.core.randomization import zeros_domain
from torch_parity import ATOL, RTOL, n, t

B = 16


def test_env_config_copy_equals_jax():
    assert dataclasses.asdict(tcfg.EnvConfig()) == dataclasses.asdict(jcfg.EnvConfig())
    assert (tcfg.BB_POS, tcfg.BB_VEL, tcfg.BB_ANG) == (jcfg.BB_POS, jcfg.BB_VEL, jcfg.BB_ANG)
    for name in ("SensorConfig", "CameraConfig", "MarkerConfig", "LandingConfig"):
        assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(
            getattr(jcfg, name)()
        ), name
    assert dataclasses.asdict(tcfg.RewardConfig.opt_variant()) == dataclasses.asdict(
        jcfg.RewardConfig.opt_variant()
    )
    for training in (True, False):
        assert dataclasses.asdict(tcfg.EnvConfig.landing_variant(training)) == dataclasses.asdict(
            jcfg.EnvConfig.landing_variant(training)
        )
    for prop in ("fx", "fy"):
        assert getattr(tcfg.CameraConfig(), prop) == getattr(jcfg.CameraConfig(), prop)
    assert tcfg.MarkerConfig().square == jcfg.MarkerConfig().square


@pytest.mark.parametrize(
    "prop", ["area", "max_motor_thrust", "hover_action_direct", "arm_drag_sum"]
)
def test_physics_properties_equal_jax(prop):
    assert getattr(tcfg.PhysicsConfig(), prop) == getattr(jcfg.PhysicsConfig(), prop)


def test_env_properties_equal_jax():
    for kw in ({}, {"vel_target_max": (1.0, 0.0, 0.5)}, {"n_steps": 300, "warmup": 2}):
        a, b = tcfg.EnvConfig(**kw), jcfg.EnvConfig(**kw)
        assert (a.max_steps, a.has_vel_target) == (b.max_steps, b.has_vel_target)


def _quats(seed):
    rng = np.random.RandomState(seed)
    ang = rng.uniform(-1.2, 1.2, (B, 3)).astype(np.float32)
    return ang, np.asarray(jq.euler_quat(jnp.asarray(ang)))


@pytest.mark.parametrize(
    "name", ["euler_quat", "quat_euler", "deriv_quat", "quat_rot_mat", "quat_normalize"]
)
def test_quaternion_matches_jax(name):
    ang, q = _quats(0)
    rng = np.random.RandomState(1)
    w = rng.normal(0, 2, (B, 3)).astype(np.float32)
    raw = (q * rng.uniform(0.5, 2.0, (B, 1))).astype(np.float32)
    args = {
        "euler_quat": (ang,),
        "quat_euler": (q,),
        "deriv_quat": (w, q),
        "quat_rot_mat": (q,),
        "quat_normalize": (raw,),
    }[name]
    want = getattr(jq, name)(*[jnp.asarray(a) for a in args])
    got = getattr(tq, name)(*[t(a) for a in args])
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _initial_states(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    from autonomous_quadrotor_environment_tpu.envs.hover import random_initial_state

    return np.asarray(jax.vmap(random_initial_state)(keys))


def _domains(randomize):
    """Per-env domains: identity, or numpy-drawn perturbations."""
    if not randomize:
        jd = jax.vmap(lambda _: jzeros())(jnp.arange(B))
        return jd, zeros_domain(B)
    rng = np.random.RandomState(7)
    f = {
        "kf_degrade": rng.uniform(0, 0.1, (B, 4)),
        "mass_factor": rng.normal(0, 0.2, (B,)),
        "ir_factor": rng.uniform(0, 0.1, (B, 4)),
        "j_factor": rng.normal(0, 0.1, (B, 3)),
        "gust_last": np.zeros((B, 3)),
        "gust_next": np.zeros((B, 3)),
        "gust_scale": np.ones((B,)),
    }
    f = {k: v.astype(np.float32) for k, v in f.items()}
    return JDom(**{k: jnp.asarray(v) for k, v in f.items()}), TDom(**{k: t(v) for k, v in f.items()})


CASES = {
    "direct": dict(direct_control=True, clipped=True, randomize=False),
    "direct_randomized": dict(direct_control=True, clipped=True, randomize=True),
    "indirect_clipped": dict(direct_control=False, clipped=True, randomize=False),
    "indirect_unclipped": dict(direct_control=False, clipped=False, randomize=False),
}


def _actions(case, rng):
    if CASES[case]["direct_control"]:
        return rng.uniform(-1.2, 1.2, (B, 4)).astype(np.float32)
    p = jcfg.PhysicsConfig()
    base = np.array([p.mass * p.gravity, 0.0, 0.0, 0.0], np.float32)
    return (base + rng.normal(0, [2.0, 0.05, 0.05, 0.01], (B, 4))).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_physics_step_matches_jax_over_steps(case):
    kw = CASES[case]
    phys = jcfg.PhysicsConfig()
    jd, td = _domains(kw["randomize"])
    rng = np.random.RandomState(3)
    wind = rng.normal(0, 1.0, (B, 3)).astype(np.float32)
    x_j = jnp.asarray(_initial_states(0))
    x_t = t(x_j)

    @jax.jit
    def jstep(x, a):
        return jax.vmap(
            lambda x, a, w, d: jdyn.physics_step(
                x, a, w, phys, d, dt=0.01, substeps=2, **kw
            )
        )(x, a, jnp.asarray(wind), jd)

    for _ in range(10):
        a = _actions(case, rng)
        x_j, aux_j = jstep(x_j, jnp.asarray(a))
        x_t, aux_t = tdyn.physics_step(
            x_t, torch.from_numpy(a), t(wind), tcfg.PhysicsConfig(), td,
            dt=0.01, substeps=2, **kw,
        )
        np.testing.assert_allclose(n(x_t), np.asarray(x_j), rtol=RTOL, atol=ATOL)
    for name in ("accel", "accelerometer_read", "mat_rot", "v_q", "f_in_z"):
        np.testing.assert_allclose(
            n(getattr(aux_t, name)), np.asarray(getattr(aux_j, name)),
            rtol=RTOL, atol=ATOL, err_msg=name,
        )
    for name in ("w", "thrust", "moment", "step_effort", "clipped_action"):
        np.testing.assert_allclose(
            n(getattr(aux_t.motor, name)), np.asarray(getattr(aux_j.motor, name)),
            rtol=RTOL, atol=ATOL, err_msg=name,
        )


@pytest.mark.parametrize("case", sorted(CASES))
def test_aux_at_state_matches_jax(case):
    kw = CASES[case]
    phys = jcfg.PhysicsConfig()
    jd, td = _domains(kw["randomize"])
    a = _actions(case, np.random.RandomState(4))
    x = _initial_states(1)
    want = jax.vmap(
        lambda x, a, d: jdyn.aux_at_state(x, a, phys, d, **kw)
    )(jnp.asarray(x), jnp.asarray(a), jd)
    got = tdyn.aux_at_state(t(x), t(a), tcfg.PhysicsConfig(), td, **kw)
    for name in ("accel", "accelerometer_read", "mat_rot", "v_q", "f_in_z"):
        np.testing.assert_allclose(
            n(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=RTOL, atol=ATOL, err_msg=name,
        )


def test_drone_eq_matches_jax():
    phys = jcfg.PhysicsConfig()
    jd, td = _domains(False)
    rng = np.random.RandomState(5)
    x = _initial_states(2)
    thrust = rng.uniform(5, 15, (B,)).astype(np.float32)
    moment = rng.normal(0, 0.1, (B, 3)).astype(np.float32)
    omega_r = rng.normal(0, 0.01, (B,)).astype(np.float32)
    wind = rng.normal(0, 1, (B, 3)).astype(np.float32)
    want = jax.vmap(
        lambda *a: jdyn.drone_eq(*a[:5], phys, a[5])
    )(*[jnp.asarray(v) for v in (x, thrust, moment, omega_r, wind)], jd)
    got = tdyn.drone_eq(t(x), t(thrust), t(moment), t(omega_r), t(wind), tcfg.PhysicsConfig(), td)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_rk4_matches_closed_form():
    """rk4 on dx/dt = -x is the fourth-order Taylor factor per step."""
    x = torch.ones(3, dtype=torch.float64)
    out = tdyn.rk4(lambda v: -v, x, dt=0.1, substeps=4)
    h = 0.025
    factor = 1 - h + h**2 / 2 - h**3 / 6 + h**4 / 24
    np.testing.assert_allclose(n(out), np.full(3, factor**4), rtol=1e-12)
