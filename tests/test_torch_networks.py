"""The port's checkpoint reader and ActorCritic against flax (CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.fixtures import FIXTURE_DIR
from autonomous_quadrotor_environment_tpu.fixtures import load_solved_controller as jload_solved
from autonomous_quadrotor_environment_tpu.ops import rollout_fused as jrf
from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
from autonomous_quadrotor_environment_tpu_torch.fixtures import SOLVED_CONTROLLER, load_solved_controller
from autonomous_quadrotor_environment_tpu_torch.ops import rollout_fused as trf
from autonomous_quadrotor_environment_tpu_torch.utils.checkpoint import load_params, read_msgpack
from torch_parity import n, t

FIXTURES = ["nn_solved_128_0.msgpack", "nn_robust_128_0.msgpack", "landing_policy.msgpack"]


@pytest.mark.parametrize("name", FIXTURES)
def test_reader_matches_flax_msgpack_restore(name):
    with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
        data = f.read()
    want = serialization.msgpack_restore(data)
    got = read_msgpack(data)
    want_leaves, want_tree = jax.tree_util.tree_flatten(want)
    got_leaves, got_tree = jax.tree_util.tree_flatten(got)
    assert got_tree == want_tree
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_load_params_casts_half_leaves_up():
    params = load_params(os.path.join(FIXTURE_DIR, "landing_policy.msgpack"))
    with open(os.path.join(FIXTURE_DIR, "landing_policy.msgpack"), "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    for g, w in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(raw)):
        assert w.dtype == np.float16 and g.dtype == np.float32
        np.testing.assert_array_equal(g, w.astype(np.float32))


def test_reader_rejects_truncated_and_unknown_data():
    with open(SOLVED_CONTROLLER, "rb") as f:
        data = f.read()
    with pytest.raises(ValueError):
        read_msgpack(data[:-10])
    with pytest.raises(ValueError):
        read_msgpack(data + b"\x00")
    with pytest.raises(ValueError):
        read_msgpack(b"\xd4\x05\x00")  # fixext1 of an ext type flax never writes


def _obs(seed, rows=64):
    return np.random.RandomState(seed).normal(0, 0.5, (rows, 75)).astype(np.float32)


def test_from_flax_solved_fixture_matches_flax_apply():
    jmodel, jparams = jload_solved()
    model = ActorCritic.from_flax(load_params(SOLVED_CONTROLLER))
    obs = _obs(0)
    mean_j, value_j, log_std_j = jmodel.apply(jparams, jnp.asarray(obs))
    with torch.no_grad():
        mean_t, value_t, log_std_t = model(t(obs))
    np.testing.assert_allclose(n(mean_t), np.asarray(mean_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(value_t), np.asarray(value_j), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(float(log_std_t), float(log_std_j), rtol=1e-7)
    with torch.no_grad():
        np.testing.assert_allclose(n(model.actor_mean(t(obs))), np.asarray(mean_j), atol=1e-5)


@pytest.mark.parametrize("hidden", [32, 128])
def test_from_flax_random_params_matches_flax_apply(hidden):
    jmodel = JActorCritic(hidden=hidden)
    jparams = jmodel.init(jax.random.PRNGKey(hidden), jnp.zeros((1, 75)))
    params = jax.tree_util.tree_map(np.asarray, jparams)
    model = ActorCritic.from_flax(params)
    assert model.hidden == hidden
    obs = _obs(1)
    mean_j, value_j, _ = jmodel.apply(jparams, jnp.asarray(obs))
    with torch.no_grad():
        mean_t, value_t, _ = model(t(obs))
    np.testing.assert_allclose(n(mean_t), np.asarray(mean_j), atol=1e-5)
    np.testing.assert_allclose(n(value_t), np.asarray(value_j), atol=1e-5)


def test_transpose_leaves_match_jax():
    _, jparams = jload_solved()
    model = load_solved_controller(device="cpu")
    want = jrf.transpose_leaves(jparams)
    got = trf.transpose_leaves(model)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(n(g), np.asarray(w))


def test_orthogonal_init():
    torch.manual_seed(0)
    model = ActorCritic(hidden=64)
    gains = [np.sqrt(2.0), np.sqrt(2.0), 0.01, np.sqrt(2.0), np.sqrt(2.0), 1.0]
    for layer, gain in zip(model.linears(), gains):
        w = n(layer.weight).astype(np.float64)
        rows, cols = w.shape
        gram = w @ w.T if rows <= cols else w.T @ w
        np.testing.assert_allclose(gram, gain**2 * np.eye(min(rows, cols)), atol=1e-5)
        assert not layer.bias.detach().any()


def test_load_solved_controller_needs_a_device_or_a_card():
    model = load_solved_controller(device="cpu")
    assert next(model.parameters()).device.type == "cpu" and not model.training
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            load_solved_controller()


def test_learned_std_round_trips_through_flax():
    """A flax tree with a learned ``log_std`` (JAX ActorCritic(learn_std=True))
    gives a model whose forward returns that float32 log_std, and `to_flax`
    gives the same tree back; `from_leaves` carries it too."""
    from autonomous_quadrotor_environment_tpu_torch.agents.networks import to_flax

    jmodel = JActorCritic(hidden=32, learn_std=True, action_std=0.2)
    jparams = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, 75)))
    )
    model = ActorCritic.from_flax(jparams, action_std=0.2)
    assert model.learn_std
    obs = _obs(2)
    mean_j, _, log_std_j = jmodel.apply(jparams, jnp.asarray(obs))
    mean_t, _, log_std_t = model(t(obs))
    assert log_std_t.dtype == torch.float32 and log_std_t.requires_grad
    assert log_std_t.item() == float(log_std_j) == np.float32(np.log(0.2))
    np.testing.assert_allclose(n(mean_t), np.asarray(mean_j), atol=1e-5)
    back = to_flax(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    leaves = [p.detach() for layer in model.linears() for p in (layer.weight, layer.bias)]
    again = ActorCritic.from_leaves(leaves, 0.2, log_std=model.log_std.detach())
    assert again.learn_std and again.log_std.item() == model.log_std.item()
    assert not ActorCritic.from_leaves(leaves, 0.2).learn_std


def test_diag_gaussian_sample_is_mean_plus_std_noise():
    from autonomous_quadrotor_environment_tpu_torch.agents.networks import DiagGaussian

    mean = torch.randn(5, 4, generator=torch.Generator().manual_seed(0))
    dist = DiagGaussian(mean, torch.tensor(np.log(0.3), dtype=torch.float32))
    got = dist.sample(torch.Generator().manual_seed(1))
    eps = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(got, mean + 0.3 * eps)
