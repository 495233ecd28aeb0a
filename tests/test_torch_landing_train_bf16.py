"""The landing trainer's other configurations against the JAX package, on
the CPU: a train step with bf16 convolutions, and `landing_step_autoreset`
(the ``reset_pool=0`` path)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.config import PPOConfig as JPPOConfig
from autonomous_quadrotor_environment_tpu.landing import env as jenv
from autonomous_quadrotor_environment_tpu.landing import ppo as jppo
from autonomous_quadrotor_environment_tpu_torch.agents.ppo import make_optimizer
from autonomous_quadrotor_environment_tpu_torch.config import PPOConfig
from autonomous_quadrotor_environment_tpu_torch.landing import env as tenv
from autonomous_quadrotor_environment_tpu_torch.landing import networks as tnet
from autonomous_quadrotor_environment_tpu_torch.landing import ppo as tppo
from torch_parity import (  # noqa: F401 (one_torch_thread: the fixture below)
    ATOL,
    RTOL,
    jax_landing_init,
    jax_landing_rollout_draws,
    jax_landing_update_draws,
    n,
    one_torch_thread,
)

B, T, POOL, K, MB = 2, 2, 2, 2, 2

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def init():
    jcfgs = jenv.LandingConfigs.default(training=True)
    jcfg = dataclasses.replace(JPPOConfig.landing_variant(), k_epochs=K, minibatch_size=MB)
    return jcfgs, jcfg, jax_landing_init(2, jcfgs, jcfg, B, conv_s2d=True,
                                         conv_dtype=jnp.bfloat16)


def test_bf16_conv_train_step_matches_jax(init):
    """bf16 convolutions and heads on both sides from the same float32
    params and draws. One train step: the loss, critic loss and reward per
    decision within rtol 2e-2, the actor loss (a mean of terms of both
    signs, advantages of unit scale) within 1e-2, the entropy within rtol
    1e-5; the parameters stay float32, and ``log_std`` is a float32 that
    the step moved (by more than 1e-5, where a bf16 log(0.1) could move by
    no less than its ulp of 0.0156), to within 1e-5 of JAX's. Then the loss on
    the port's rollout rows, the same inputs on both sides: loss within
    rtol 1e-2, and each gradient as close to JAX's bf16 one as bf16 allows:
    its relative Frobenius error from it at most 1.5 times JAX's own from
    the float32 gradient, plus 1e-3 (bf16 keeps 8 bits, and the two sides
    round and accumulate in their own orders: 0.5-1.05 times that error
    per leaf, up to 0.10 in a conv bias, 0.023 in a kernel, when this test
    was written)."""
    jcfgs, jcfg, ((cm, cp, jmodel, tx, jstate), (ctrl, tcfgs, states, obs)) = init
    jnew, jmet = jax.jit(jppo.make_landing_train_step(jmodel, tx, jcfgs, jcfg, cm, cp, T))(jstate)
    _key, k_roll, k_upd = jax.random.split(jstate.key, 3)
    draws, _ = jax_landing_rollout_draws(jstate.env_states.key, k_roll, T, POOL,
                                         np.zeros((T, B), bool))
    cfg = dataclasses.replace(PPOConfig.landing_variant(), k_epochs=K, minibatch_size=MB)
    params = jax.device_get(jstate.params)
    model = tnet.LandingActorCritic.from_flax(params, conv_dtype=torch.bfloat16)
    fresh = copy.deepcopy(model)
    opt = make_optimizer(model, cfg)
    state = tppo.LandingTrainState(model, opt, states, obs, torch.Generator())
    step = tppo.make_landing_train_step(model, opt, tcfgs, cfg, ctrl, T)
    _, met = step(state, draws, jax_landing_update_draws(k_upd, tppo.update_plan(cfg, T * B), K))
    assert float(met["episodes"]) == 0.0
    for k in ("loss", "critic_loss", "reward_per_decision"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=2e-2, err_msg=k)
    np.testing.assert_allclose(float(met["actor_loss"]), float(jmet["actor_loss"]), atol=1e-2)
    np.testing.assert_allclose(float(met["entropy"]), float(jmet["entropy"]), rtol=1e-5)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.log_std.dtype == torch.float32
    assert jnew.params["params"]["log_std"].dtype == jnp.float32
    assert abs(float(model.log_std.detach()) - float(fresh.log_std.detach())) > 1e-5
    np.testing.assert_allclose(float(model.log_std.detach()),
                               float(jnew.params["params"]["log_std"]), atol=1e-5)

    _, _, roll, boot = tppo.landing_rollout(fresh, states, obs, None, tcfgs, ctrl, T, POOL,
                                            draws=draws)
    returns, advs = tppo.gae_advantages(roll.rewards, roll.values, roll.dones, boot)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    rows = [flat(x) for x in (roll.images, roll.sens, roll.actions, roll.logprobs, returns,
                              advs)]
    loss, _ = tppo.landing_loss(fresh, *rows, cfg)
    grads = torch.autograd.grad(loss, list(fresh.parameters()))
    f32 = copy.deepcopy(fresh)
    f32.conv_dtype = torch.float32
    g32 = torch.autograd.grad(tppo.landing_loss(f32, *rows, cfg)[0], list(f32.parameters()))
    with torch.no_grad():
        for p, g in zip(f32.parameters(), g32):
            p.copy_(g)
    ref32 = dict(jax.tree_util.tree_leaves_with_path(tnet.to_flax(f32)))
    jrows = [n(x) for x in rows]
    jrows[0] = jrows[0].transpose(0, 2, 3, 1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, *a: jppo.landing_loss(jmodel, p, *a, jcfg)[0]))(params, *jrows)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-2)
    with torch.no_grad():
        for p, g in zip(fresh.parameters(), grads):
            p.copy_(g)
    want = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads)))
    for path, g in jax.tree_util.tree_leaves_with_path(tnet.to_flax(fresh)):
        w = np.asarray(want[path], np.float32)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        r32 = np.linalg.norm(w - ref32[path]) / max(np.linalg.norm(ref32[path]), 1e-30)
        assert rel <= 1.5 * r32 + 1e-3, (jax.tree_util.keystr(path), rel, r32)


def test_landing_step_autoreset_matches_jax(init):
    """Env 0 is past its time budget, so its episode ends and a fresh one
    starts from the reset draws of JAX's second key; env 1 steps on. State
    and observation at the landing step test's tolerances (rtol 2e-4,
    atol 2e-5; reward 1e-4); done, solved and the key chains equal."""
    jcfgs, _, ((cm, cp, _jm, _tx, jstate), (ctrl, tcfgs, states, _obs)) = init
    late = jnp.array([1500, 0], jnp.int32)
    js = jstate.env_states.replace(internal_frame=jstate.env_states.internal_frame + late)
    ps = states.replace(internal_frame=states.internal_frame + torch.tensor([1500, 0],
                                                                            dtype=torch.int32))
    action = np.array([[0.3, -0.2, 0.1], [-0.5, 0.4, -0.9]], np.float32)
    js2, jout = jax.jit(jax.vmap(lambda s, a: jenv.landing_step_autoreset(
        s, a, jcfgs, cm, cp)))(js, jnp.asarray(action))
    np.testing.assert_array_equal(np.asarray(jout.done), [True, False])
    draws, keys = jax_landing_rollout_draws(js.key, jax.random.PRNGKey(0), 1, 0,
                                            np.asarray(jout.done)[None])
    ps2, pout = tenv.landing_step_autoreset(
        ps, torch.from_numpy(action), tcfgs, ctrl, noise=tppo._at(draws.noise, 0),
        reset_draws=tppo._at(draws.reset, 0), reset_noise=tppo._at(draws.reset_noise, 0))
    np.testing.assert_array_equal(keys, np.asarray(js2.key))
    np.testing.assert_array_equal(n(pout.done), np.asarray(jout.done))
    np.testing.assert_array_equal(n(pout.solved), np.asarray(jout.solved))
    np.testing.assert_allclose(n(pout.reward), np.asarray(jout.reward), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(n(ps2.internal_frame), np.asarray(js2.internal_frame))
    for name in ("x", "hist", "i"):
        np.testing.assert_allclose(n(getattr(ps2.env, name)).astype(np.float32),
                                   np.asarray(getattr(js2.env, name)).astype(np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    for a, b in ((ps2.marker_world, js2.marker_world), (ps2.sens.pos_ins, js2.sens.pos_ins),
                 (ps2.hist, js2.hist), (ps2.last_shaping, js2.last_shaping),
                 (pout.obs.control_in, jout.obs.control_in)):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(n(pout.obs.image), np.asarray(jout.obs.image).transpose(0, 3, 1, 2),
                               rtol=RTOL, atol=ATOL)

