"""The port's landing CNN and reward against the JAX package, on the CPU:
the shipped policy's weights carried across in both first-conv layouts,
and the reward's terminal table (`landing_step` is in
test_torch_landing_step.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from autonomous_quadrotor_environment_tpu.landing import networks as jnet
from autonomous_quadrotor_environment_tpu.landing.reward import visual_reward as jreward
from autonomous_quadrotor_environment_tpu.utils import load_params as jload_params
from autonomous_quadrotor_environment_tpu_torch.fixtures import LANDING_POLICY, load_landing_policy
from autonomous_quadrotor_environment_tpu_torch.landing import env as tenv
from autonomous_quadrotor_environment_tpu_torch.landing import networks as tnet
from autonomous_quadrotor_environment_tpu_torch.landing.reward import visual_reward
from autonomous_quadrotor_environment_tpu_torch.render import make_camera, render_nadir
from autonomous_quadrotor_environment_tpu_torch.utils.checkpoint import load_params
from torch_parity import n, one_torch_thread, t  # noqa: F401

B = 4
# The CNN's tolerance: float32 convolutions and a 6272-long dense sum in
# another order than XLA's; the tanh action is held absolutely, the
# critic's unbounded value relatively.
MEAN_ATOL, VALUE_RTOL, VALUE_ATOL = 1e-5, 1e-4, 1e-5

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@functools.lru_cache(maxsize=None)
def _jax_policy():
    """The fixture's params as JAX's `load_params` gives them (the port's
    reader; test_shipped_fixture_loads_as_jax_loads_it holds the two
    equal), without flax's slow CNN init."""
    return None, jax.tree.map(jnp.asarray, load_params(LANDING_POLICY))


@functools.lru_cache(maxsize=None)
def _jax_apply(s2d):
    return jax.jit(lambda p, img, sens: jnet.LandingActorCritic(conv_s2d=s2d).apply(p, img, sens))


def _images(seed):
    rng = np.random.default_rng(seed)
    quad = np.stack([rng.normal(0, 0.5, B), rng.normal(0, 0.5, B),
                     rng.uniform(-4.8, 0.0, B)], -1).astype(np.float32)
    marker = rng.normal(0, 0.3, (B, 2)).astype(np.float32)
    img = render_nadir(make_camera(), t(quad), t(marker), tenv.MarkerConfig())
    sens = rng.normal(0, 0.5, (B, 75)).astype(np.float32)
    return img, t(sens)


@pytest.mark.parametrize("s2d", [False, True])
def test_from_flax_matches_flax_apply(s2d):
    """The shipped policy (and its space-to-depth form) on 4 rendered
    images: action mean within atol 1e-5, value within rtol 1e-4 (atol
    1e-5), log_std equal."""
    _, jparams = _jax_policy()
    if s2d:
        jparams = jnet.params_to_s2d(jparams)
    img, sens = _images(0)
    jmean, jvalue, jlog_std = _jax_apply(s2d)(jparams, jnp.asarray(n(img.permute(0, 2, 3, 1))),
                                              jnp.asarray(n(sens)))
    model = tnet.LandingActorCritic.from_flax(jax.tree.map(np.asarray, jparams))
    assert model.conv_s2d == s2d
    with torch.no_grad():
        mean, value, log_std = model(img, sens)
        actor = model.actor(img, sens)
    np.testing.assert_allclose(n(mean), np.asarray(jmean), atol=MEAN_ATOL, rtol=0)
    np.testing.assert_allclose(n(value), np.asarray(jvalue), rtol=VALUE_RTOL, atol=VALUE_ATOL)
    assert torch.equal(actor, mean)
    assert log_std.dtype == torch.float32 and float(log_std.detach()) == float(jlog_std)
    assert np.abs(np.asarray(jmean)).max() > 1e-2  # the policy is not at rest here


def test_shipped_fixture_loads_as_jax_loads_it(tmp_path):
    # JAX's `load_params` into a template of the JAX model's own shapes
    # (`fixtures.load_landing_policy` without running flax's CNN init).
    shapes = jax.eval_shape(
        jnet.LandingActorCritic().init, jax.random.PRNGKey(0), jnp.zeros((1, 84, 84, 3)),
        jnp.zeros((1, 75)), jnp.zeros((1, 3)))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jparams = jload_params(LANDING_POLICY, template)
    ours = load_params(LANDING_POLICY)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert len(flat_j) == len(flat_t) == 25
    for path, leaf in flat_j:
        assert flat_t[path].dtype == np.float32
        np.testing.assert_array_equal(flat_t[path], np.asarray(leaf), err_msg=str(path))
    assert tnet.detect_s2d(LANDING_POLICY) is False
    assert jnet.detect_s2d(LANDING_POLICY) is False
    # A space-to-depth checkpoint written by the JAX package reads as one.
    path = tmp_path / "s2d.msgpack"
    path.write_bytes(serialization.to_bytes(jnet.params_to_s2d(jparams)))
    assert tnet.detect_s2d(str(path)) is True
    model = load_landing_policy(device="cpu")
    assert not model.training and model.log_std.dtype == torch.float32
    assert float(model.log_std.detach()) == float(jparams["params"]["log_std"])


def test_params_s2d_round_trip_is_bitwise_and_matches_jax():
    ours = load_params(LANDING_POLICY)
    s2d = tnet.params_to_s2d(ours)
    want = jnet.params_to_s2d(jax.tree.map(jnp.asarray, ours))
    for trunk in ("conv_ac", "conv_ct"):
        k = s2d["params"][trunk]["Conv_0"]["kernel"]
        assert k.shape == (2, 2, 48, 64)
        np.testing.assert_array_equal(k, np.asarray(want["params"][trunk]["Conv_0"]["kernel"]))
    back = tnet.params_from_s2d(s2d)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ours):
        got = functools.reduce(lambda d, k: d[k.key], path, back)
        assert np.array_equal(got, leaf), path
    # The source tree is not modified.
    assert ours["params"]["conv_ac"]["Conv_0"]["kernel"].shape == (8, 8, 3, 64)


def test_space_to_depth_folds_channels_in_p1_p2_c_order():
    img = torch.arange(2 * 3 * 8 * 8, dtype=torch.float32).reshape(2, 3, 8, 8)
    got = tnet.space_to_depth(img)  # (2, 48, 2, 2)
    nhwc = n(img.permute(0, 2, 3, 1)).reshape(2, 2, 4, 2, 4, 3)  # b h p1 w p2 c
    want = nhwc.transpose(0, 1, 3, 2, 4, 5).reshape(2, 2, 2, 48)  # b h w (p1 p2 c)
    np.testing.assert_array_equal(n(got.permute(0, 2, 3, 1)), want)


def test_log_std_stays_float32_under_dtype_changes():
    model = tnet.LandingActorCritic().to(torch.bfloat16)
    assert model.actor_out.weight.dtype == torch.bfloat16
    assert model.log_std.dtype == torch.float32


# (landed z, speed, roll, rate, error_xy, step, has_shaping): one per branch
# of the terminal table (JAX landing/reward.py:75-96).
REWARD_CASES = {
    "solved": (-4.97, 0.1, 0.0, 0.1, 0.05, 500, True),
    "soft_flat_off_target": (-4.97, 0.1, 0.0, 0.1, 0.3, 500, True),
    "soft_not_flat": (-4.97, 0.1, 0.6, 0.1, 0.05, 500, True),
    "soft_spinning": (-4.97, 0.1, 0.0, 2.0, 0.05, 500, True),
    "hard": (-4.97, 0.8, 0.0, 0.1, 0.05, 500, True),
    "astray_xy": (-2.0, 0.5, 0.0, 0.1, 3.5, 500, True),
    "flying": (-3.0, 0.5, 0.0, 0.1, 0.5, 500, True),
    "first_step": (-3.0, 0.5, 0.0, 0.1, 0.5, 10, False),
    "timeout_overrides_landed": (-4.97, 0.1, 0.0, 0.1, 0.05, 1501, True),
    "timeout_flying": (-3.0, 0.5, 0.0, 0.1, 0.5, 1501, True),
    "at_timeout_limit": (-3.0, 0.5, 0.0, 0.1, 0.5, 1500, True),
}


def test_visual_reward_terminal_table_matches_jax():
    rows = list(REWARD_CASES.values())
    m = len(rows)
    z, speed, roll, rate, exy, step, has = (np.array(c) for c in zip(*rows))
    marker = np.tile(np.array([0.3, -0.2, 0.001], np.float32), (m, 1))
    quad = np.stack([0.3 + exy, np.full(m, -0.2), z], -1).astype(np.float32)
    vel = np.stack([np.zeros(m), np.zeros(m), -speed], -1).astype(np.float32)
    control = np.tile(np.array([0.2, -0.1, 0.4], np.float32), (m, 1))
    ang = np.stack([roll, np.zeros(m), np.full(m, 0.3)], -1).astype(np.float32)
    v_ang = np.stack([rate, np.zeros(m), np.zeros(m)], -1).astype(np.float32)
    last = np.full(m, -9.0, np.float32)
    args = (marker, quad, vel, control, last, has, step.astype(np.int32), ang, v_ang)
    want = jax.vmap(lambda *a: jreward(1500, *a))(*map(jnp.asarray, args))
    got = visual_reward(1500, *(t(a) for a in args))
    np.testing.assert_allclose(n(got.reward), np.asarray(want.reward), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(got.shaping), np.asarray(want.shaping), rtol=1e-6)
    np.testing.assert_array_equal(n(got.done), np.asarray(want.done))
    np.testing.assert_array_equal(n(got.solved), np.asarray(want.solved))
    reward = dict(zip(REWARD_CASES, n(got.reward)))
    solved = dict(zip(REWARD_CASES, n(got.solved)))
    assert reward["solved"] == 5.0 and solved["solved"]
    assert reward["soft_flat_off_target"] == 1.0 and reward["soft_not_flat"] == 0.0
    assert reward["soft_spinning"] == 0.0 and reward["hard"] == -1.0
    assert reward["astray_xy"] == -5.0
    assert reward["timeout_overrides_landed"] == -2.0 and reward["timeout_flying"] == -2.0
    assert sum(solved.values()) == 2  # a timed-out touchdown still counts as solved
    assert not n(got.done)[list(REWARD_CASES).index("at_timeout_limit")]
    assert reward["first_step"] == pytest.approx(-0.1 * np.linalg.norm(control[0]), rel=1e-6)
