"""The port's classical baselines against the JAX package's, on the CPU: the
PID loop, both cascaded PID variants, the velocity PID, the LQR gains and
control law on the same numpy-seeded batches (B=64), and the LQR closed
loops' stability."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu import baselines as jb
from autonomous_quadrotor_environment_tpu.config import PhysicsConfig as JPhysics
from autonomous_quadrotor_environment_tpu_torch import baselines as tb
from autonomous_quadrotor_environment_tpu_torch.config import PhysicsConfig
from torch_parity import n, t

B = 64
DT = 0.01
# Elementwise float32 arithmetic in the same order on both sides, but for
# the closed-form 3x3 solve (the JAX package takes an LU solve) and the
# libraries' transcendental functions: a few ulps.
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=rtol, atol=atol)


def _batch(seed):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return {"pos": f(B, 3), "vel": f(B, 3), "ang": f(B, 3, scale=0.3),
            "ang_vel": f(B, 3), "xd": f(B, 3), "dxd": f(B, 3), "psi_d": f(B, scale=0.2),
            "ix": f(B, 6, scale=0.1), "x_old": f(B, 6, scale=0.5),
            "ang_d_ant": f(B, 3, scale=0.3)}


def _states(d):
    """The same cascaded PID state in both packages: the JAX one batched."""
    loops = ("x", "y", "z", "phi", "theta", "psi")
    jstate = jb.CascadedPIDState(
        **{k: jb.PIDState(ix=jnp.asarray(d["ix"][:, i]), x_old=jnp.asarray(d["x_old"][:, i]))
           for i, k in enumerate(loops)},
        ang_d_ant=jnp.asarray(d["ang_d_ant"]))
    tstate = tb.CascadedPIDState(
        **{k: tb.PIDState(ix=t(d["ix"][:, i]), x_old=t(d["x_old"][:, i]))
           for i, k in enumerate(loops)},
        ang_d_ant=t(d["ang_d_ant"]))
    return jstate, tstate


@pytest.mark.parametrize("dom", [False, True])
def test_pid_step_matches_jax(dom):
    d = _batch(0)
    gains = (2.0, 0.5, 0.3)
    js = jb.PIDState(ix=jnp.asarray(d["ix"][:, 0]), x_old=jnp.asarray(d["x_old"][:, 0]))
    args = [d[k][:, 0] for k in ("pos", "vel", "xd", "dxd")]
    jnew, ju = jax.vmap(lambda s, *a: jb.pid_step(s, *a, gains, DT, dom))(
        js, *map(jnp.asarray, args))
    tnew, tu = tb.pid_step(tb.PIDState(t(d["ix"][:, 0]), t(d["x_old"][:, 0])),
                           *map(t, args), gains, DT, dom)
    _close(tu, ju)
    _close(tnew.ix, jnew.ix)
    _close(tnew.x_old, jnew.x_old)


@pytest.mark.parametrize("gains", ["POSITION_GAINS", "VELOCITY_GAINS",
                                   "VELOCITY_GAINS_UNCLIPPED"])
def test_cascaded_pid_control_matches_jax(gains):
    """Both variants: atan with the passed rates (position), atan2 with the
    derivative on the measurement in every loop (velocity)."""
    d = _batch(1)
    jstate, tstate = _states(d)
    keys = ("pos", "vel", "ang", "ang_vel", "xd", "dxd", "psi_d")
    jg, tg = getattr(jb, gains), getattr(tb, gains)
    jnew, jact = jax.vmap(lambda s, *a: jb.cascaded_pid_control(s, *a, jg, JPhysics(), DT))(
        jstate, *(jnp.asarray(d[k]) for k in keys))
    tnew, tact = tb.cascaded_pid_control(tstate, *(t(d[k]) for k in keys), tg,
                                         PhysicsConfig(), DT)
    # The moments come out of the 3x3 solve, whose entries reach 1/j = 59;
    # hold them relative to their own scale.
    _close(tact[:, 0], jact[:, 0])
    np.testing.assert_allclose(n(tact[:, 1:]), np.asarray(jact[:, 1:]), rtol=RTOL,
                               atol=RTOL * float(np.abs(np.asarray(jact[:, 1:])).max()))
    _close(tnew.ang_d_ant, jnew.ang_d_ant)
    for loop in ("x", "y", "z", "phi", "theta", "psi"):
        _close(getattr(tnew, loop).ix, getattr(jnew, loop).ix)
        _close(getattr(tnew, loop).x_old, getattr(jnew, loop).x_old)


def test_euler_rate_solve_matches_the_jax_linear_solve():
    ang = np.random.RandomState(2).uniform(-1.2, 1.2, size=(B, 3)).astype(np.float32)
    u = np.random.RandomState(3).normal(size=(B, 3)).astype(np.float32)
    jm = jax.vmap(lambda a: jb.pid._euler_rate_inertia(a, JPhysics()))(jnp.asarray(ang))
    want = jax.vmap(jnp.linalg.solve)(jm, jnp.asarray(u))
    tm = tb.pid._euler_rate_inertia(t(ang), PhysicsConfig())
    _close(tm, jm)
    got = tb.pid._solve_euler_rate(tm, t(u))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(want)).max()))


def test_vel_pid_matches_jax():
    rng = np.random.RandomState(4)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    state, target, cumm, pd, pp = f(B, 13), f(B, 14), f(B, 3), f(B, 3), f(B, 3)
    js = jb.VelPIDState(cumm_error=jnp.asarray(cumm), prev_pos_d=jnp.asarray(pd),
                        prev_pos=jnp.asarray(pp))
    jnew, jerr = jax.vmap(jb.vel_pid)(js, jnp.asarray(state), jnp.asarray(target))
    tnew, terr = tb.vel_pid(tb.VelPIDState(t(cumm), t(pd), t(pp)), t(state), t(target))
    _close(terr, jerr)
    for k in ("cumm_error", "prev_pos_d", "prev_pos"):
        _close(getattr(tnew, k), getattr(jnew, k))
    init = tb.vel_pid_init(3)
    assert init.cumm_error.shape == (3, 3) and not init.cumm_error.any()


@pytest.mark.parametrize("clipped", [True, False])
def test_lqr_gains_equal_jax(clipped):
    """The same scipy CARE solves in float64, cast to float32: bit-equal."""
    want = jb.make_lqr_gains(JPhysics(), clipped=clipped)
    got = tb.make_lqr_gains(PhysicsConfig(), clipped=clipped)
    assert got.k_t.dtype == torch.float32 and got.k_att.dtype == torch.float32
    np.testing.assert_array_equal(n(got.k_t), np.asarray(want.k_t))
    np.testing.assert_array_equal(n(got.k_att), np.asarray(want.k_att))


@pytest.mark.parametrize("clipped", [True, False])
def test_lqr_control_matches_jax(clipped):
    d = _batch(5)
    jg = jb.make_lqr_gains(JPhysics(), clipped=clipped)
    tg = tb.make_lqr_gains(PhysicsConfig(), clipped=clipped)
    keys = ("vel", "ang", "ang_vel", "ang_d_ant")
    jact, jeul = jax.vmap(lambda *a: jb.lqr_control(jg, *a, JPhysics(), DT))(
        *(jnp.asarray(d[k]) for k in keys))
    tact, teul = tb.lqr_control(tg, *(t(d[k]) for k in keys), PhysicsConfig(), DT)
    _close(teul, jeul)
    np.testing.assert_allclose(n(tact), np.asarray(jact), rtol=RTOL,
                               atol=RTOL * float(np.abs(np.asarray(jact)).max()))


@pytest.mark.parametrize("clipped", [True, False])
def test_lqr_closed_loops_are_hurwitz(clipped):
    """A + B K of both double-integrator loops has every eigenvalue in the
    open left half plane."""
    phys = PhysicsConfig()
    g = tb.make_lqr_gains(phys, clipped=clipped)
    a = np.zeros((6, 6))
    a[0, 1] = a[2, 3] = a[4, 5] = 1.0
    b_att = np.zeros((6, 4))
    b_att[1, 1], b_att[3, 2], b_att[5, 3] = 1 / phys.j_xx, 1 / phys.j_yy, 1 / phys.j_zz
    b_t = np.zeros((6, 3))
    b_t[1, 0] = b_t[3, 1] = b_t[5, 2] = 1 / phys.mass
    for b, k in ((b_att, g.k_att), (b_t, g.k_t)):
        eig = np.linalg.eigvals(a + b @ n(k).astype(np.float64))
        assert (eig.real < 0).all(), eig
