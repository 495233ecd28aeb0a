"""The port's landing trainer against the JAX package, on the CPU, in
float32 with the space-to-depth first conv: from JAX-initialized params and
envs (episodes cut to 2 decisions, so the reset pool is used and wraps
around) and JAX's own draws and permutations, one `landing_rollout`;
`landing_loss` and its gradients on a minibatch of JAX's rollout; one
`make_landing_train_step` (the same rollout, then K=2 epochs of 2
minibatches with the per-row shuffle): the params, Adam's moments and the
metrics after it; and the train loop against sequential steps."""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.config import LandingConfig as JLandingConfig
from autonomous_quadrotor_environment_tpu.config import PPOConfig as JPPOConfig
from autonomous_quadrotor_environment_tpu.landing import env as jenv
from autonomous_quadrotor_environment_tpu.landing import ppo as jppo
from autonomous_quadrotor_environment_tpu_torch.agents.ppo import make_optimizer
from autonomous_quadrotor_environment_tpu_torch.config import PPOConfig
from autonomous_quadrotor_environment_tpu_torch.landing import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.landing.networks import (
    LandingActorCritic,
    to_flax,
)
from torch_parity import (  # noqa: F401 (one_torch_thread: the fixture below)
    ATOL,
    RTOL,
    jax_landing_init,
    jax_landing_rollout_draws,
    jax_landing_update_draws,
    n,
    one_torch_thread,
)

B, T, POOL = 2, 4, 2
K, MB = 2, 4  # 8 rows: 2 minibatches of 4 per epoch, per-row shuffle
# 25 physics steps: each episode times out at its second decision, so every
# env takes a pool episode at decisions 1 and 3, the second one wrapping
# around to slot 0.
TOTAL_STEPS = 25
# Tolerances. Images and the state-derived rows (sens) at the step-math
# tolerance; the CNN's action at the landing tests' 1e-5
# (test_torch_landing_step.py); log-probs, values and bootstrap (sums of
# 768-wide products) at 1e-4 absolute and relative; rewards at the landing
# step test's 1e-4. Loss at rtol 1e-5; gradients by relative Frobenius
# error per leaf (elementwise errors do not survive cancellation).
ACT_ATOL, VALUE_TOL, REWARD_ATOL, LOSS_RTOL, GRAD_REL = 1e-5, 1e-4, 1e-4, 1e-5, 1e-4

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def run():
    jcfgs = jenv.LandingConfigs.default(training=True)
    jcfgs = jcfgs._replace(landing=JLandingConfig(total_steps=TOTAL_STEPS))
    jppo_cfg = dataclasses.replace(JPPOConfig.landing_variant(), k_epochs=K, minibatch_size=MB)
    (cm, cp, jmodel, _tx, jstate), (ctrl, tcfgs, states, obs) = jax_landing_init(
        0, jcfgs, jppo_cfg, B, conv_s2d=True)
    _key, k_roll, _k_upd = jax.random.split(jstate.key, 3)
    roll_fn = jax.jit(lambda p, s, o, k: jppo.landing_rollout(
        jmodel, p, s, o, k, jcfgs, cm, cp, T, reset_pool=POOL))
    js, jobs, jroll, jboot = roll_fn(jstate.params, jstate.env_states, jstate.obs, k_roll)
    draws, keys_after = jax_landing_rollout_draws(jstate.env_states.key, k_roll, T, POOL,
                                                  jroll.dones)
    params = jax.device_get(jstate.params)
    model = LandingActorCritic.from_flax(params)
    ps, pobs, proll, pboot = tppo.landing_rollout(model, states, obs, None, tcfgs, ctrl, T,
                                                  POOL, draws=draws)
    # The train step from the same state rolls out from the same key.
    jnew, jmet = jax.jit(jppo.make_landing_train_step(jmodel, _tx, jcfgs, jppo_cfg, cm, cp, T))(
        jstate)
    cfg = dataclasses.replace(PPOConfig.landing_variant(), k_epochs=K, minibatch_size=MB)
    plan = tppo.update_plan(cfg, T * B)
    assert plan.n_mb == 2 and plan.block == 1 and not plan.full_batch
    smodel = LandingActorCritic.from_flax(params)
    opt = make_optimizer(smodel, cfg)
    state = tppo.LandingTrainState(smodel, opt, states, obs, torch.Generator())
    train_step = tppo.make_landing_train_step(smodel, opt, tcfgs, cfg, ctrl, T)
    new, met = train_step(state, draws, jax_landing_update_draws(_k_upd, plan, K))
    return dict(jmodel=jmodel, params=params, jppo_cfg=jppo_cfg, model=model, js=js,
                jobs=jobs, jroll=jroll, jboot=jboot, keys_after=keys_after, ps=ps, pobs=pobs,
                proll=proll, pboot=pboot, jnew=jnew, jmet=jmet, smodel=smodel, opt=opt,
                new=new, met=met, tcfgs=tcfgs, ctrl=ctrl, cfg=cfg, states=states, obs=obs)


def test_rollout_matches_jax(run):
    jr, pr = run["jroll"], run["proll"]
    assert pr.images.shape == (T, B, 3, 84, 84) and pr.images.dtype == torch.float32
    np.testing.assert_array_equal(n(pr.dones), np.asarray(jr.dones))
    assert np.asarray(jr.dones)[[1, 3]].all() and not np.asarray(jr.dones)[[0, 2]].any()
    np.testing.assert_array_equal(n(pr.solved), np.asarray(jr.solved))
    np.testing.assert_allclose(n(pr.images), np.asarray(jr.images).transpose(0, 1, 4, 2, 3),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(n(pr.sens), np.asarray(jr.sens), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(n(pr.actions), np.asarray(jr.actions), atol=ACT_ATOL, rtol=0)
    for name in ("logprobs", "values"):
        np.testing.assert_allclose(n(getattr(pr, name)), np.asarray(getattr(jr, name)),
                                   rtol=VALUE_TOL, atol=VALUE_TOL, err_msg=name)
    np.testing.assert_allclose(n(pr.rewards), np.asarray(jr.rewards), atol=REWARD_ATOL, rtol=0)
    np.testing.assert_allclose(n(run["pboot"]), np.asarray(run["jboot"]), rtol=VALUE_TOL,
                               atol=VALUE_TOL)


def test_rollout_ends_where_jax_does(run):
    """The envs after the rollout (the last pool episode and its frames) and
    the next observation; the walked key chains end where JAX's do."""
    ps, js = run["ps"], run["js"]
    np.testing.assert_array_equal(run["keys_after"], np.asarray(js.key))
    np.testing.assert_allclose(n(ps.env.x), np.asarray(js.env.x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(n(ps.sens.pos_ins), np.asarray(js.sens.pos_ins),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(n(ps.internal_frame), np.asarray(js.internal_frame))
    np.testing.assert_allclose(n(run["pobs"].image),
                               np.asarray(run["jobs"].image).transpose(0, 3, 1, 2),
                               rtol=RTOL, atol=ATOL)


def test_rollout_draws_from_a_generator(run):
    """Without injected draws the rollout draws its own; uint8 storage is
    the JAX package's clip(round(x * 255)) bit for bit."""
    model = run["model"]
    ps, pobs = run["ps"], run["pobs"]
    from autonomous_quadrotor_environment_tpu_torch.fixtures import load_solved_controller
    from autonomous_quadrotor_environment_tpu_torch.landing.env import LandingConfigs

    gen = torch.Generator().manual_seed(0)
    _, _, roll, boot = tppo.landing_rollout(
        model, ps, pobs, gen, LandingConfigs.default(), load_solved_controller("cpu"), 2,
        image_dtype=torch.uint8)
    assert roll.images.dtype == torch.uint8 and boot.shape == (B,)
    want = np.asarray(jax.numpy.clip(jax.numpy.round(run["jroll"].images * 255.0), 0, 255)
                      .astype(jax.numpy.uint8)).transpose(0, 1, 4, 2, 3)
    store = tppo._store_image(torch.uint8)
    np.testing.assert_array_equal(n(store(torch.from_numpy(
        np.asarray(run["jroll"].images).transpose(0, 1, 4, 2, 3).copy()))), want)


def _tree(model, tensors):
    """A flax tree of ``tensors`` (one per parameter of ``model``)."""
    m = copy.deepcopy(model)
    with torch.no_grad():
        for p, x in zip(m.parameters(), tensors):
            p.copy_(x)
    return to_flax(m)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(jax.device_get(tree)))


def _minibatch(run, rows):
    jr = run["jroll"]
    returns, advs = jax.jit(lambda r, v, d, b: jppo.gae_advantages(r, v, d, b, 0.99, 0.99))(
        jr.rewards, jr.values, jr.dones, run["jboot"])
    flat = lambda x: np.asarray(x).reshape((-1,) + x.shape[2:])[rows]
    return tuple(flat(x) for x in (jr.images, jr.sens, jr.actions, jr.logprobs, returns, advs))


def test_loss_and_gradients_match_jax(run):
    """`landing_loss` on 4 rows of JAX's rollout: loss and its metrics at
    rtol 1e-5, every parameter's gradient within 1e-4 relative Frobenius
    error of JAX's."""
    rows = np.array([5, 0, 6, 3])
    mbatch = _minibatch(run, rows)
    cfg = PPOConfig.landing_variant()
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, *a: jppo.landing_loss(run["jmodel"], p, *a, run["jppo_cfg"]),
        has_aux=True))(run["params"], *mbatch)
    model = copy.deepcopy(run["model"])
    images = torch.from_numpy(mbatch[0].transpose(0, 3, 1, 2).copy())
    loss, met = tppo.landing_loss(model, images, *(torch.from_numpy(x) for x in mbatch[1:]), cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    for k in ("actor_loss", "critic_loss", "entropy"):
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]), rtol=LOSS_RTOL, err_msg=k)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.copy_(g)
    got = jax.tree_util.tree_leaves_with_path(to_flax(model))
    want = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads)))
    assert len(got) == len(want) == 25
    for path, g in got:
        w = np.asarray(want[path])
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= GRAD_REL, (jax.tree_util.keystr(path), rel)


def test_train_step_matches_jax(run):
    """The step's rollout is `test_rollout_matches_jax`'s, reset pool and
    all. Metrics within rtol 1e-4 (episodes and solved_frac equal); Adam's
    moments within 1e-4 relative Frobenius error per leaf; each parameter's
    change over the step's 4 Adam steps within 2e-7 of JAX's (lr 2e-5: a
    step moves a weight by at most about 2e-5, by lr * sign(g) on the
    first step), counting no more than 1 in 1e4 elements whose gradient
    sign flips between the two (each up to 2 * lr)."""
    model, opt, jnew = run["smodel"], run["opt"], run["jnew"]
    assert run["new"].update_i == 1
    for k, v in run["met"].items():
        np.testing.assert_allclose(float(v), float(run["jmet"][k]), rtol=1e-4, err_msg=k)
    assert float(run["met"]["episodes"]) == 4.0  # each env's at decisions 1 and 3
    params = list(model.parameters())
    mu = _tree(model, [opt.state[p]["exp_avg"] for p in params])
    nu = _tree(model, [opt.state[p]["exp_avg_sq"] for p in params])
    adam = jnew.opt_state[0]
    assert int(adam.count) == int(opt.state[params[0]]["step"]) == K * 2
    for got, want, name in ((mu, adam.mu, "mu"), (nu, adam.nu, "nu")):
        want = _leaves(want)
        for path, g in jax.tree_util.tree_leaves_with_path(got):
            w = np.asarray(want[path])
            rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert rel <= 1e-4, (name, jax.tree_util.keystr(path), rel)
    old = _leaves(run["params"])
    got = _leaves(to_flax(model))
    flips = total = 0
    for path, w in _leaves(jnew.params).items():
        d = (got[path] - old[path]) - (np.asarray(w) - old[path])
        flips += int((np.abs(d) > 2e-7).sum())
        total += d.size
    assert flips <= total * 1e-4, (flips, total)


def test_train_loop_is_sequential_steps(run):
    """`make_landing_train_loop` with inner=2 gives what two calls of the
    train step give from the same model, optimizer and generator seed, bit
    for bit; its metrics are stacked per update."""
    cfg, tcfgs, ctrl = run["cfg"], run["tcfgs"], run["ctrl"]
    outs = []
    for loop in (True, False):
        model = copy.deepcopy(run["model"])  # the JAX-initialized params
        opt = make_optimizer(model, cfg)
        state = tppo.LandingTrainState(model, opt, run["states"], run["obs"],
                                       torch.Generator().manual_seed(3))
        if loop:
            state, met = tppo.make_landing_train_loop(model, opt, tcfgs, cfg, ctrl, 2, 2)(state)
        else:
            train_step = tppo.make_landing_train_step(model, opt, tcfgs, cfg, ctrl, 2)
            rows = []
            for _ in range(2):
                state, m = train_step(state)
                rows.append(m)
            met = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        outs.append((state, met, [p.detach().clone() for p in model.parameters()]))
    (s1, m1, p1), (s2, m2, p2) = outs
    assert s1.update_i == s2.update_i == 2
    assert set(m1) == set(m2) and all(v.shape == (2,) for v in m1.values())
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
    assert torch.equal(s1.env_states.env.x, s2.env_states.env.x)
    assert torch.equal(s1.obs.image, s2.obs.image)
