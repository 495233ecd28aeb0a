"""The pieces of the port's PPO trainer against the JAX package's, on the
CPU: the config copies, the policy head, `to_flax`, the optimizer,
`ppo_loss`, the update rows, `update_t_tile` and `ppo_update_t` with JAX's
permutations injected.

Tolerances: updated parameters within atol lr * 0.05 and metrics within
rtol 5e-4, those of the JAX package's own fully-fused-vs-materialized test
(tests/test_ops_t.py:140-147); the rest as stated per test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autonomous_quadrotor_environment_tpu import config as jcfg
from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.agents.networks import DiagGaussian as JDiagGaussian
from autonomous_quadrotor_environment_tpu.agents.ppo import make_optimizer as jmake_optimizer
from autonomous_quadrotor_environment_tpu.agents.ppo import ppo_loss as jppo_loss
from autonomous_quadrotor_environment_tpu.agents.ppo import ppo_update_t as jppo_update_t
from autonomous_quadrotor_environment_tpu_torch import config as tcfg
from autonomous_quadrotor_environment_tpu_torch.agents import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.agents.networks import (
    LEAVES,
    ActorCritic,
    DiagGaussian,
    to_flax,
)
from torch_parity import assert_params_close, jax_perms, n, t

# The fully fused configuration of tests/test_ops_t.py, small.
STEPS, B, HIDDEN = 8, 16, 32
PPO = dict(k_epochs=3, minibatch_size=64, fused_update=True, shuffle_block=8)


def test_config_copies_equal_the_jax_package():
    for name in ("PPOConfig", "TrainConfig"):
        assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(
            getattr(jcfg, name)()
        ), name
    assert dataclasses.asdict(tcfg.PPOConfig.landing_variant()) == dataclasses.asdict(
        jcfg.PPOConfig.landing_variant()
    )


def test_diag_gaussian_matches_jax():
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(5, 4)).astype(np.float32)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    log_std = np.float32(np.log(0.1))
    jd = JDiagGaussian(jnp.asarray(mean), jnp.asarray(log_std))
    td = DiagGaussian(t(mean), torch.tensor(log_std))
    np.testing.assert_allclose(n(td.log_prob(t(x))), np.asarray(jd.log_prob(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(td.entropy()), np.asarray(jd.entropy()), rtol=1e-6)
    assert td.log_std.dtype == torch.float32


def test_to_flax_inverts_from_flax():
    params = JActorCritic(hidden=HIDDEN).init(jax.random.PRNGKey(2), jnp.zeros((1, 75)))
    model = ActorCritic.from_flax(jax.tree.map(np.asarray, params))
    back = to_flax(model)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


def test_adam_and_clipping_match_optax():
    """Three steps of the port's Adam (with and without global-norm
    clipping) on the same gradients as optax's, to 1e-6 (the bias
    corrections associate differently: sqrt(v / c2) against sqrt(v) /
    sqrt(c2))."""
    rng = np.random.default_rng(1)
    for max_norm in (0.0, 0.5):
        cfg = tcfg.PPOConfig(lr=1e-2, max_grad_norm=max_norm)
        jc = jcfg.PPOConfig(lr=1e-2, max_grad_norm=max_norm)
        params = JActorCritic(hidden=8).init(jax.random.PRNGKey(0), jnp.zeros((1, 75)))
        model = ActorCritic.from_flax(jax.tree.map(np.asarray, params))
        opt = tppo.make_optimizer(model, cfg)
        tx = jmake_optimizer(jc)
        state = tx.init(params)
        torch_params = [p for l in model.linears() for p in (l.weight, l.bias)]
        for _ in range(3):
            g = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), params)
            upd, state = tx.update(g, state, params)
            params = optax.apply_updates(params, upd)
            gp = g["params"]
            grads = [t(np.asarray(gp[h][d][k]).T if k == "kernel" else np.asarray(gp[h][d][k]))
                     for h, d, k in LEAVES]
            if max_norm > 0:
                tppo.clip_by_global_norm_(grads, max_norm)
            for p, gg in zip(torch_params, grads):
                p.grad = gg.contiguous()
            opt.step()
        assert_params_close(model, params, atol=1e-6)


def test_ppo_loss_matches_jax():
    rng = np.random.default_rng(2)
    rows = 96
    obs = (rng.normal(size=(rows, 75)) * 0.3).astype(np.float32)
    act = (rng.normal(size=(rows, 4)) * 0.2).astype(np.float32)
    old = (rng.normal(size=(rows, 4)) * 0.1 - 1.0).astype(np.float32)
    ret = rng.normal(size=rows).astype(np.float32)
    adv = rng.normal(size=rows).astype(np.float32)
    jmodel = JActorCritic(hidden=HIDDEN)
    params = jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, 75)))
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jppo_loss(jmodel, p, obs, act, old, ret, adv, jcfg.PPOConfig()), has_aux=True
    )(params)
    model = ActorCritic.from_flax(jax.tree.map(np.asarray, params))
    lt, mt = tppo.ppo_loss(model, t(obs), t(act), t(old), t(ret), t(adv), tcfg.PPOConfig())
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-5)
    for k in mj:
        np.testing.assert_allclose(mt[k].item(), float(mj[k]), rtol=2e-5, err_msg=k)
    got = {}
    for layer, (h, d, _) in zip(model.linears(), LEAVES[0::2]):
        got[(h, d, "kernel")] = n(layer.weight.grad).T
        got[(h, d, "bias")] = n(layer.bias.grad)
    for key in LEAVES:
        want = np.asarray(gj["params"][key[0]][key[1]][key[2]])
        np.testing.assert_allclose(got[key], want, rtol=2e-4,
                                   atol=2e-7 + 1e-5 * np.abs(want).max(), err_msg=str(key))


def _update_rows(seed=0):
    """Seeded numpy update rows in the transposed layout: obs (T, 75, B) and
    aux (T, 8, B) = action(4), old logprob sum, return, advantage, 0."""
    rng = np.random.default_rng(seed)
    obs_t = (rng.normal(size=(STEPS, 75, B)) * 0.3).astype(np.float32)
    aux_t = np.zeros((STEPS, 8, B), np.float32)
    aux_t[:, 0:4] = rng.normal(size=(STEPS, 4, B)) * 0.2
    aux_t[:, 4] = rng.normal(size=(STEPS, B)) * 0.4 - 4.0
    aux_t[:, 5] = rng.normal(size=(STEPS, B))
    aux_t[:, 6] = rng.normal(size=(STEPS, B))
    return obs_t, aux_t


def test_pack_aux_t_follows_the_jax_layout():
    rng = np.random.default_rng(3)
    misc = rng.normal(size=(STEPS, 16, B)).astype(np.float32)
    returns = rng.normal(size=(STEPS, B)).astype(np.float32)
    advs = rng.normal(size=(STEPS, B)).astype(np.float32)
    got = n(tppo.pack_aux_t(t(misc), t(returns), t(advs)))
    # jax agents/ppo.py make_train_step's aux_t concatenation.
    old_lp_sum = jnp.sum(misc[:, 4:8], axis=1, keepdims=True)
    want = jnp.concatenate([misc[:, 0:4], old_lp_sum, returns[:, None], advs[:, None],
                            jnp.zeros_like(old_lp_sum)], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("minibatch", [64, 0])
def test_ppo_update_t_matches_jax(minibatch):
    obs_t, aux_t = _update_rows()
    kw = dict(PPO, minibatch_size=minibatch)
    cfg = jcfg.PPOConfig(**kw)
    params = JActorCritic(hidden=HIDDEN, action_std=0.1).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 75))
    )
    tx = jmake_optimizer(cfg)
    key = jax.random.PRNGKey(11)
    pj, _, mj = jppo_update_t(tx, params, tx.init(params), jnp.asarray(obs_t),
                              jnp.asarray(aux_t), key, cfg)
    tile = tppo.update_t_tile(tcfg.PPOConfig(**kw), STEPS, B)
    assert tile == 8
    n_rows = STEPS * B
    n_mb = n_rows // minibatch if minibatch else 1
    perms = jax_perms(key, cfg.k_epochs, n_rows // tile, n_mb)

    model = ActorCritic.from_flax(jax.tree.map(np.asarray, params))
    opt = tppo.make_optimizer(model, tcfg.PPOConfig(**kw))
    mt = tppo.ppo_update_t(model, opt, t(obs_t), t(aux_t), None, tcfg.PPOConfig(**kw),
                           perms=torch.from_numpy(perms))
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=5e-4, err_msg=k)
    assert_params_close(model, pj, atol=cfg.lr * 0.05)


def test_update_t_tile_matches_jax():
    from autonomous_quadrotor_environment_tpu.agents.ppo import update_t_tile as jtile

    for mb, block, steps, b in [(0, 1024, 256, 8192), (0, 1024, 256, 96),
                                (1000, 1024, 256, 8192), (64, 8, 8, 16), (0, 128, 128, 1024),
                                (524288, 1024, 256, 8192), (0, 1, 4, 16)]:
        kw = dict(minibatch_size=mb, shuffle_block=block)
        assert tppo.update_t_tile(tcfg.PPOConfig(**kw), steps, b) == jtile(
            jcfg.PPOConfig(**kw), steps, b
        )
