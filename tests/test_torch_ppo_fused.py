"""The port's row-major PPO gradient and Adam step (kernels B3 and B4's plain
versions, `ppo_grad_plain` and `ppo_grad_adam_plain`) against the JAX
package's `fused_ppo_grad` and `fused_ppo_grad_adam` run in interpret mode,
on the same rows, weights, block ids and Adam state; and the wrappers'
dispatch on the CPU.

Tolerance: rtol 2e-5 on the loss and metrics, and rtol 2e-4 with atol
2e-7 + 1e-5 of the leaf's largest entry on each gradient, new parameter
and Adam moment: those of tests/test_torch_ppo_fused_t.py, whose docstring
gives the reason for the atol's second term (cancelling sums over the
rows). The Adam state is warmed (seeded moments of the gradients' size at
step 3): from empty moments Adam's first step is lr * sign(g), and an entry
whose gradient cancels to near zero can take either sign on the two sides
without a fault on either."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.ops import ppo_fused as jpf
from autonomous_quadrotor_environment_tpu_torch.agents.networks import LEAVES, ActorCritic
from autonomous_quadrotor_environment_tpu_torch.ops import ppo_fused as tpf
from torch_parity import n, t

ROWS, TILE = 96, 8
STD, CLIP, ENT = 0.1, 0.2, 0.006
LR, B1, B2 = 5e-4, 0.9, 0.999
KW = dict(action_std=STD, clip_eps=CLIP, entropy_coef=ENT)


def _data(hidden, seed=0):
    """Seeded numpy rows (obs, actions, old logprobs, returns, advantages)
    with ratios on both sides of the clip band, and flax params."""
    rng = np.random.default_rng(seed)
    obs = (rng.standard_normal((ROWS, 75)) * 0.3).astype(np.float32)
    actions = (rng.standard_normal((ROWS, 4)) * 0.2).astype(np.float32)
    old_lp = (rng.standard_normal((ROWS, 4)) * 0.1 + 0.4).astype(np.float32)
    rets = rng.standard_normal(ROWS).astype(np.float32)
    advs = rng.standard_normal(ROWS).astype(np.float32)
    params = JActorCritic(hidden=hidden, action_std=STD).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 75))
    )
    return obs, actions, old_lp, rets, advs, jax.tree.map(np.asarray, params)


def _flat(tree):
    """A flax tree -> the 12 leaves in leaf order, (out, in) like the port's."""
    p = tree["params"]
    leaves = [np.asarray(p[h][d][k]) for h, d, k in LEAVES]
    return [x.T if x.ndim == 2 else x for x in leaves]


def assert_leaf_close(got, want, name):
    atol = 2e-7 + 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=atol, err_msg=name)


BLOCKS = {"shuffled_subset": [3, 0, 7, 5, 1, 10], "every_block": list(range(ROWS // TILE))}


def test_pack_aux_matches_jax():
    obs, actions, old_lp, rets, advs, _ = _data(32)
    want = jpf.pack_aux(jnp.asarray(actions), jnp.asarray(old_lp), jnp.asarray(rets),
                        jnp.asarray(advs))
    got = tpf.pack_aux(t(actions), t(old_lp), t(rets), t(advs))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert got.is_contiguous() and got.dtype == torch.float32


@pytest.mark.parametrize("hidden", [128, 32])
@pytest.mark.parametrize("which", sorted(BLOCKS))
def test_plain_grad_matches_jax_kernel(hidden, which):
    obs, actions, old_lp, rets, advs, params = _data(hidden)
    aux = tpf.pack_aux(t(actions), t(old_lp), t(rets), t(advs))
    blocks = np.asarray(BLOCKS[which], np.int32)
    loss_j, met_j, grads_j = jpf.fused_ppo_grad(
        params, jnp.asarray(obs), jnp.asarray(n(aux)), jnp.asarray(blocks), tile=TILE,
        interpret=True, **KW,
    )
    model = ActorCritic.from_flax(params, action_std=STD)
    loss_t, met_t, grads_t = tpf.ppo_grad_plain(model, t(obs), aux, torch.from_numpy(blocks),
                                                tile=TILE, **KW)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-5)
    for key, want in met_j.items():
        np.testing.assert_allclose(float(met_t[key]), float(want), rtol=2e-5, err_msg=key)
    for name, gt, gj in zip(LEAVES, grads_t, _flat(grads_j)):
        assert tuple(gt.shape) == gj.shape, name
        assert_leaf_close(n(gt), gj, str(name))


def _warm_state(params, seed=1):
    """Seeded Adam moments of the gradients' size (flax trees) at count 3."""
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32), params)
    nu = jax.tree.map(lambda p: (rng.uniform(1e-5, 1e-3, p.shape)).astype(np.float32), params)
    return mu, nu, 3


def test_plain_grad_adam_matches_jax_kernel():
    """One whole minibatch step with the Adam update, from a warmed state:
    loss and metrics, new params, mu and nu, and the count."""
    obs, actions, old_lp, rets, advs, params = _data(32, seed=2)
    aux = tpf.pack_aux(t(actions), t(old_lp), t(rets), t(advs))
    blocks = np.asarray(BLOCKS["shuffled_subset"], np.int32)
    mu, nu, count = _warm_state(params)
    loss_j, met_j, p_j, mu_j, nu_j, count_j = jpf.fused_ppo_grad_adam(
        params, mu, nu, jnp.asarray(count, jnp.int32), jnp.asarray(obs), jnp.asarray(n(aux)),
        jnp.asarray(blocks), tile=TILE, lr=LR, adam_b1=B1, adam_b2=B2, interpret=True, **KW,
    )
    model = ActorCritic.from_flax(params, action_std=STD)
    loss_t, met_t, p_t, mu_t, nu_t, count_t = tpf.ppo_grad_adam_plain(
        model, [t(x) for x in _flat(mu)], [t(x) for x in _flat(nu)], count, t(obs), aux,
        torch.from_numpy(blocks), tile=TILE, lr=LR, b1=B1, b2=B2, **KW,
    )
    assert count_t == int(count_j) == count + 1
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-5)
    for key, want in met_j.items():
        np.testing.assert_allclose(float(met_t[key]), float(want), rtol=2e-5, err_msg=key)
    for what, got, want in (("params", p_t, p_j), ("mu", mu_t, mu_j), ("nu", nu_t, nu_j)):
        for name, g, w in zip(LEAVES, got, _flat(want)):
            assert tuple(g.shape) == w.shape, (what, name)
            assert_leaf_close(n(g), w, f"{what} {name}")
    # The step moved every leaf, by about lr per entry at most.
    for g, w in zip(p_t, _flat(params)):
        assert 0 < np.abs(n(g) - w).max() < 20 * LR


def _model_and_rows(seed=3):
    obs, actions, old_lp, rets, advs, params = _data(32, seed=seed)
    aux = tpf.pack_aux(t(actions), t(old_lp), t(rets), t(advs))
    return ActorCritic.from_flax(params, action_std=STD), t(obs), aux


def test_adam_wrapper_steps_the_optimizer_state_in_place():
    """On the CPU `fused_ppo_grad_adam` is `ppo_grad_plain` followed by
    `opt.step()` on the model's `torch.optim.Adam`, from an empty state and
    after it (from an empty state the same as `ppo_grad_adam_plain` on
    copies of it); then `opt.step()` carries on from the state it left."""
    blocks = torch.tensor([2, 9, 4], dtype=torch.int32)
    m1, obs, aux = _model_and_rows()
    m2, _, _ = _model_and_rows()
    o1 = torch.optim.Adam(m1.parameters(), lr=LR, betas=(B1, B2), eps=1e-8)
    o2 = torch.optim.Adam(m2.parameters(), lr=LR, betas=(B1, B2), eps=1e-8)
    p2 = [p for l in m2.linears() for p in (l.weight, l.bias)]
    zeros = [torch.zeros_like(p) for p in p2]
    _, _, p_ref, _, _, _ = tpf.ppo_grad_adam_plain(m2, zeros, zeros, 0, obs, aux, blocks,
                                                   tile=TILE, lr=LR, b1=B1, b2=B2, **KW)
    for i in range(2):
        loss1, met1 = tpf.fused_ppo_grad_adam(m1, o1, obs, aux, blocks, tile=TILE, **KW)
        if i == 0:
            for a, b in zip([p for l in m1.linears() for p in (l.weight, l.bias)], p_ref):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
        loss2, met2, grads = tpf.fused_ppo_grad(m2, obs, aux, blocks, tile=TILE, **KW)
        for p, g in zip(p2, grads):
            p.grad = g
        o2.step()
        assert float(loss1) == float(loss2)
        for a, b in zip(m1.parameters(), m2.parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    for p in m1.parameters():
        assert int(o1.state[p]["step"]) == 2
        p.grad = torch.ones_like(p)
    o1.step()
    assert all(int(o1.state[p]["step"]) == 3 for p in m1.parameters())


def test_wrappers_refuse_what_they_do_not_take():
    model, obs, aux = _model_and_rows()
    blocks = torch.tensor([0, 1], dtype=torch.int32)
    meta = [x.to("meta") for x in (obs, aux, blocks)]
    with pytest.raises(ValueError):
        tpf.fused_ppo_grad(model, *meta, tile=TILE, **KW)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    with pytest.raises(ValueError):
        tpf.fused_ppo_grad_adam(model, opt, *meta, tile=TILE, **KW)
    for other in (torch.optim.SGD(model.parameters(), lr=0.1),
                  torch.optim.Adam(model.parameters(), lr=LR, amsgrad=True),
                  torch.optim.Adam(list(model.parameters())[:4], lr=LR)):
        assert not tpf.adam_takes(other, model)
        with pytest.raises(ValueError):
            tpf.fused_ppo_grad_adam(model, other, obs, aux, blocks, tile=TILE, **KW)
    assert tpf.adam_takes(opt, model)


def test_supports_and_gather_rows():
    model, obs, _ = _model_and_rows()
    leaves = tpf._leaves(model)
    assert tpf.supports(obs, leaves, TILE)      # hidden 32: any width up to 256
    big = tpf._leaves(ActorCritic(hidden=128))
    assert tpf.supports(obs, big, TILE) and tpf.supports(obs, big, 3)
    assert not tpf.supports(obs, big, 40)       # does not divide 96 rows
    for hidden in (257, 1024, 1025):            # the wide kernels, any width
        assert tpf.supports(obs, tpf._leaves(ActorCritic(hidden=hidden)), TILE)
    short = tpf._leaves(ActorCritic(hidden=32, obs_dim=60))
    assert tpf.supports(obs[:, :60], short, TILE) and not tpf.supports(obs, short, TILE)
    x = torch.arange(12.0)[:, None].expand(12, 2)
    rows = tpf.gather_rows(x, torch.tensor([2, 0]), tile=3)
    assert rows[:, 0].tolist() == [6, 7, 8, 0, 1, 2]
