"""The port's quaternion additions and sensor suite against the JAX
package, on the CPU, with the JAX package's own draws injected into the
port (`torch_parity.jax_sensor_draws` walks the same key splits)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.config import PhysicsConfig as JPhys
from autonomous_quadrotor_environment_tpu.config import SensorConfig as JSensorConfig
from autonomous_quadrotor_environment_tpu.core import quaternion as jq
from autonomous_quadrotor_environment_tpu.core.dynamics import aux_at_state as jaux
from autonomous_quadrotor_environment_tpu.core.randomization import zeros_domain as jzeros
from autonomous_quadrotor_environment_tpu.envs import sensors as js
from autonomous_quadrotor_environment_tpu_torch.config import PhysicsConfig, SensorConfig
from autonomous_quadrotor_environment_tpu_torch.core import quaternion as tq
from autonomous_quadrotor_environment_tpu_torch.core.dynamics import aux_at_state
from autonomous_quadrotor_environment_tpu_torch.core.randomization import zeros_domain
from autonomous_quadrotor_environment_tpu_torch.envs import sensors as ts
from torch_parity import ATOL, RTOL, jax_sensor_draws, n, t

B = 16


def _axis_angle(axis, angle):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + math.sin(angle) * k + (1 - math.cos(angle)) * k @ k


def _rotations():
    rng = np.random.default_rng(0)
    mats = [_axis_angle(ax, math.pi) for ax in ([1, 0, 0], [0, 1, 0], [0, 0, 1],
                                                [1, 1, 0], [1, 1, 1], [0, -1, 1])]
    mats.append(np.eye(3))
    for _ in range(25):
        mats.append(_axis_angle(rng.normal(size=3), rng.uniform(-math.pi, math.pi)))
    return np.stack(mats).astype(np.float32)


def test_rot_mat_quat_matches_jax():
    """Tolerance rtol 1e-6 (atol 1e-7 for components that are zero): the
    same candidates, pivot (first index on ties) and sign rule; 180-degree
    rotations about each axis and about diagonals put the pivot at a tie
    or on the sign rule's edge."""
    r = _rotations()
    got = tq.rot_mat_quat(t(r))
    want = jq.rot_mat_quat(jnp.asarray(r))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert (n(got)[:, 0] >= 0).all()
    # The quaternion maps back to the same rotation.
    np.testing.assert_allclose(n(tq.quat_rot_mat(got)), r, atol=2e-6)


def test_rot_mat_quat_breaks_ties_to_the_first_pivot():
    # Pivots 1 + m00 - m11 - m22 and 1 - m00 + m11 - m22 tie at 2: the x
    # candidate (index 1) is taken, whose w is m21 - m12 = +0.25.
    r = torch.tensor([[0.0, 0.75, 0.0], [0.75, 0.0, -0.25], [0.0, 0.25, -1.0]])
    got = tq.rot_mat_quat(r)
    want = jq.rot_mat_quat(jnp.asarray(n(r)))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_quat_mul_matches_jax():
    rng = np.random.default_rng(1)
    p, q = rng.normal(size=(2, 32, 4)).astype(np.float32)
    np.testing.assert_allclose(
        n(tq.quat_mul(t(p), t(q))), np.asarray(jq.quat_mul(p, q)), rtol=1e-6, atol=1e-7
    )
    # Broadcasting and the identity.
    e = torch.tensor([1.0, 0.0, 0.0, 0.0])
    assert torch.equal(tq.quat_mul(e, t(q)), t(q))


def _states(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 13)).astype(np.float32)
    x[:, 6:10] /= np.linalg.norm(x[:, 6:10], axis=1, keepdims=True)
    x[:, 10:13] *= 0.5
    action = rng.uniform(-1, 1, size=(B, 4)).astype(np.float32)
    return x, action


def _reads(x, action):
    jphys = JPhys()
    jr = jax.vmap(lambda xi, ai: js.reads_from_env(
        xi, jaux(xi, ai, jphys, jzeros(), direct_control=True)))(x, action)
    aux = aux_at_state(t(x), t(action), PhysicsConfig(), zeros_domain(B), direct_control=True)
    return jr, ts.reads_from_env(t(x), aux)


SENSOR_FIELDS = ("a_b_accel", "a_b_grav", "g_b", "m_b", "a_b_d", "g_b_d", "m_b_d",
                 "pos_ins", "vel_ins", "quat_ins", "r_est")


def _assert_sens_close(ps, jss):
    for name in SENSOR_FIELDS:
        np.testing.assert_allclose(n(getattr(ps, name)), np.asarray(getattr(jss, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("primary", [False, True])
@pytest.mark.parametrize("enabled", [True, False])
def test_sensor_reset_and_fused_match_jax(primary, enabled):
    """Three fused reads in a row from a reset, JAX's draws injected:
    every carried field and every output within the step-math tolerance
    rtol 2e-4, atol 2e-5 (the biases, the INS carry and, in the primary
    variant, the TRIAD estimate carry over)."""
    jcfg, cfg = JSensorConfig(enabled=enabled), SensorConfig(enabled=enabled)
    jphys, phys, dt = JPhys(), PhysicsConfig(), 0.01
    x, action = _states(2)
    jr, pr = _reads(x, action)
    keys = jax.random.split(jax.random.PRNGKey(5), B)

    jss = jax.jit(jax.vmap(lambda k, r: js.sensor_reset(k, r, jcfg)))(keys, jr)
    drift = jax.vmap(lambda k: jnp.stack([
        jax.random.uniform(ki, (), jnp.float32) for ki in jax.random.split(k, 3)]))(keys)
    ps = ts.sensor_reset(t(drift), pr, cfg)
    _assert_sens_close(ps, jss)

    fused = jax.jit(jax.vmap(
        lambda s, r, k: js.sensor_fused(s, r, k, jcfg, jphys, dt, primary)))
    keys = jax.random.split(jax.random.PRNGKey(10), (3, B))
    normal, uniform = jax_sensor_draws(keys, primary)
    for step in range(3):
        jss, jout = fused(jss, jr, keys[step])
        ps, pout = ts.sensor_fused(ps, pr, ts.SensorNoise(t(normal[step]), t(uniform[step])),
                                   cfg, phys, dt, primary)
        _assert_sens_close(ps, jss)
        for name in ts.FusedOut._fields:
            np.testing.assert_allclose(n(getattr(pout, name)), np.asarray(getattr(jout, name)),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{name} at read {step}")
    if not enabled and not primary:
        # Without noise the opt TRIAD observes the true rotated vectors and
        # recovers the true attitude (up to sign).
        q_true = x[:, 6:10] * np.sign(x[:, 6:7])
        np.testing.assert_allclose(n(pout.quaternion_triad), q_true, atol=1e-4)


def test_gyro_int_returns_the_unnormalized_quaternion():
    x, action = _states(3)
    _, pr = _reads(x, action)
    ps = ts.sensor_reset(torch.full((B, 3), 0.5), pr, SensorConfig())
    noise = torch.randn(B, 3, generator=torch.Generator().manual_seed(0))
    s2, q_new = ts.gyro_int(ps, pr, noise, SensorConfig(), 0.01)
    assert not torch.allclose(torch.linalg.vector_norm(q_new, dim=-1), torch.ones(B))
    torch.testing.assert_close(s2.quat_ins, q_new / torch.linalg.vector_norm(q_new, dim=-1,
                                                                             keepdim=True))


def test_draw_sensor_noise_shapes_and_ranges():
    noise = ts.draw_sensor_noise(torch.Generator().manual_seed(0), (10, B))
    assert noise.normal.shape == (10, B, ts.N_NORMAL, 3)
    assert noise.uniform.shape == (10, B, ts.N_UNIFORM, 3)
    assert 0.0 <= noise.uniform.min() and noise.uniform.max() < 1.0
