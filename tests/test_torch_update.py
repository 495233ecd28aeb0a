"""The port's row-major `ppo_update` against the JAX package's, on the CPU,
in every branch its gates pick, with JAX's per-epoch permutations
injected; and the learned std (`learn_std`) against the JAX package's.

Tolerances: updated parameters within atol lr * 0.05 and metrics within
rtol 5e-4, those of the JAX package's own fused-vs-XLA update test
(tests/test_ops.py:test_fused_update_integration_matches_xla); the loss
and its gradients under a learned std as tests/test_torch_ppo.py holds
them without one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu import config as jcfg
from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.agents.ppo import Rollout as JRollout
from autonomous_quadrotor_environment_tpu.agents.ppo import make_optimizer as jmake_optimizer
from autonomous_quadrotor_environment_tpu.agents.ppo import ppo_loss as jppo_loss
from autonomous_quadrotor_environment_tpu.agents.ppo import ppo_update as jppo_update
from autonomous_quadrotor_environment_tpu_torch import config as tcfg
from autonomous_quadrotor_environment_tpu_torch.agents import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.agents.networks import LEAVES, ActorCritic
from torch_parity import assert_params_close, jax_perms, n, t

STEPS, B, HIDDEN = 8, 16, 32
ROWS = STEPS * B
BASE = dict(k_epochs=3, minibatch_size=64, shuffle_block=8)

# branch -> (config fields, the port's branch, its block, its kernel tile)
BRANCHES = {
    "autograd": (dict(), "autograd", 8, 0),
    "autograd_block1": (dict(minibatch_size=60), "autograd", 1, 0),
    "b3": (dict(fused_update=True), "fused", 8, 8),
    "b4": (dict(fused_update=True, fused_adam=True), "fused_adam", 8, 8),
    "full_batch": (dict(minibatch_size=0, shuffle_block=1, fused_update=True), "fused", 1, 128),
    "clipped": (dict(max_grad_norm=0.5, fused_update=True, fused_adam=True), "fused", 8, 8),
}


def _rollout(jmodel, jparams, seed=0):
    """A seeded rollout (T, B) whose logprobs are the policy's own at the
    stored actions, so the ratios start at 1, plus dones and a bootstrap;
    as JAX and as the port's `Rollout`."""
    rng = np.random.default_rng(seed)
    obs = (rng.standard_normal((STEPS, B, 75)) * 0.3).astype(np.float32)
    mean, values, log_std = jmodel.apply(jparams, jnp.asarray(obs))
    eps = rng.standard_normal((STEPS, B, 4)).astype(np.float32)
    actions = mean + jnp.exp(log_std) * eps
    logprobs = -0.5 * eps**2 - log_std - 0.5 * np.log(2 * np.pi)
    rewards = rng.standard_normal((STEPS, B)).astype(np.float32)
    dones = rng.random((STEPS, B)) < 0.1
    jroll = JRollout(*(jnp.asarray(x) for x in (
        obs, actions, logprobs, values, rewards, dones, np.zeros((STEPS, B), bool))))
    troll = tppo.Rollout(*(t(x) for x in jroll))
    bootstrap = rng.standard_normal(B).astype(np.float32)
    return jroll, troll, bootstrap


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_ppo_update_matches_jax(branch):
    fields, want_branch, want_block, want_tile = BRANCHES[branch]
    kw = dict(BASE, **fields)
    jc, pc = jcfg.PPOConfig(**kw), tcfg.PPOConfig(**kw)
    jmodel = JActorCritic(hidden=HIDDEN, action_std=jc.action_std)
    jparams = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 75)))
    jroll, troll, bootstrap = _rollout(jmodel, jparams)
    tx = jmake_optimizer(jc)
    key = jax.random.PRNGKey(7)
    pj, _, mj = jax.jit(lambda p, s: jppo_update(jmodel, tx, p, s, jroll, bootstrap, key, jc))(
        jparams, tx.init(jparams)
    )

    plan = tppo.update_plan(pc, ROWS)
    assert (plan.branch, plan.block, plan.tile) == (want_branch, want_block, want_tile)
    perms = None
    if not plan.full_batch:
        perms = torch.from_numpy(jax_perms(key, jc.k_epochs, ROWS // plan.block, plan.n_mb,
                                           plan.mb // plan.block))
    model = ActorCritic.from_flax(jax.tree.map(np.asarray, jparams))
    opt = tppo.make_optimizer(model, pc)
    mt = tppo.ppo_update(model, opt, troll, t(bootstrap), None, pc, perms)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=5e-4, err_msg=k)
    assert_params_close(model, pj, atol=jc.lr * 0.05)
    steps = {int(opt.state[p]["step"]) for p in model.parameters()}
    assert steps == {jc.k_epochs * plan.n_mb}


def test_update_plan_follows_the_jax_gates():
    """The branch choice is the JAX package's, never the card kernels':
    a learned std and a tile that does not divide go to autograd, a
    non-Adam optimizer keeps the Adam step out of the kernel."""
    p = tcfg.PPOConfig(fused_update=True, fused_adam=True, minibatch_size=64, shuffle_block=8)
    assert tppo.update_plan(p, ROWS).branch == "fused_adam"
    assert tppo.update_plan(p, ROWS, plain_adam=False).branch == "fused"
    assert tppo.update_plan(p, ROWS, learn_std=True).branch == "autograd"
    full = tcfg.PPOConfig(fused_update=True, shuffle_block=1)
    assert tppo.update_plan(full, 3 * 512).tile == 512           # min(n, 512) divides
    assert tppo.update_plan(full, 3 * 500).branch == "autograd"   # 512 does not
    odd = tcfg.PPOConfig(fused_update=True, minibatch_size=48, shuffle_block=40)
    plan = tppo.update_plan(odd, 1200)                             # 40 divides neither 48...
    assert (plan.block, plan.branch) == (1, "autograd")           # ...so block 1, no kernel
    plan = tppo.update_plan(dataclasses.replace(odd, minibatch_size=520), 1200)
    assert (plan.block, plan.tile, plan.n_mb) == (40, 40, 2)


def _learn_std_model(seed=2):
    jmodel = JActorCritic(hidden=HIDDEN, learn_std=True, action_std=0.1)
    jparams = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 75)))
    jparams = jax.tree.map(np.asarray, jparams)
    jparams["params"]["log_std"] = np.float32(np.log(0.15))
    return jmodel, jparams


def test_learned_std_loss_and_gradients_match_jax():
    jmodel, jparams = _learn_std_model()
    rng = np.random.default_rng(3)
    rows = 64
    obs = (rng.normal(size=(rows, 75)) * 0.3).astype(np.float32)
    act = (rng.normal(size=(rows, 4)) * 0.2).astype(np.float32)
    old = (rng.normal(size=(rows, 4)) * 0.1 - 1.0).astype(np.float32)
    ret = rng.normal(size=rows).astype(np.float32)
    adv = rng.normal(size=rows).astype(np.float32)
    cfg = jcfg.PPOConfig(learn_std=True)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jppo_loss(jmodel, p, obs, act, old, ret, adv, cfg), has_aux=True
    )(jparams)
    model = ActorCritic.from_flax(jparams)
    assert model.learn_std and model.log_std.dtype == torch.float32
    lt, mt = tppo.ppo_loss(model, t(obs), t(act), t(old), t(ret), t(adv),
                           tcfg.PPOConfig(learn_std=True))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-5)
    for k in mj:
        np.testing.assert_allclose(mt[k].item(), float(mj[k]), rtol=2e-5, err_msg=k)
    want = float(gj["params"]["log_std"])
    assert abs(want) > 1e-3  # the entropy bonus and the logprobs pull on it
    np.testing.assert_allclose(model.log_std.grad.item(), want, rtol=2e-4)
    for layer, (h, d, _) in zip(model.linears(), LEAVES[0::2]):
        w = np.asarray(gj["params"][h][d]["kernel"])
        np.testing.assert_allclose(n(layer.weight.grad).T, w, rtol=2e-4,
                                   atol=2e-7 + 1e-5 * np.abs(w).max(), err_msg=f"{h}/{d}")


def test_learned_std_stays_float32_and_adam_moves_it_as_jax_does():
    """A whole update with a learned std (the JAX gate sends it to
    autograd even with fused_update on): the port's log_std and weights
    follow the JAX package's; log_std moved, and stays float32 when the
    rest of the model changes type."""
    jmodel, jparams = _learn_std_model()
    kw = dict(BASE, learn_std=True, fused_update=True, lr=1e-2)
    jc, pc = jcfg.PPOConfig(**kw), tcfg.PPOConfig(**kw)
    jroll, troll, bootstrap = _rollout(jmodel, jparams, seed=4)
    tx = jmake_optimizer(jc)
    key = jax.random.PRNGKey(8)
    pj, _, _ = jax.jit(lambda p, s: jppo_update(jmodel, tx, p, s, jroll, bootstrap, key, jc))(
        jparams, tx.init(jparams)
    )
    model = ActorCritic.from_flax(jparams)
    opt = tppo.make_optimizer(model, pc)
    assert tppo.update_plan(pc, ROWS, learn_std=True).branch == "autograd"
    perms = torch.from_numpy(jax_perms(key, jc.k_epochs, ROWS // 8, 2))
    tppo.ppo_update(model, opt, troll, t(bootstrap), None, pc, perms)
    assert_params_close(model, pj, atol=jc.lr * 0.05)
    got, want = model.log_std.item(), float(pj["params"]["log_std"])
    np.testing.assert_allclose(got, want, rtol=0, atol=jc.lr * 0.05)
    assert abs(got - np.log(0.15)) > jc.lr  # Adam moved it
    half = model.to(torch.bfloat16)
    assert half.log_std.dtype == torch.float32 and half.log_std.item() == got
