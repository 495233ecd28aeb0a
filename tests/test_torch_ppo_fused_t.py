"""The port's PPO gradient (kernel B2's plain version, `ppo_grad_t_plain`)
against the JAX package's `fused_ppo_grad_t` run in interpret mode, on the
same rows, weights and block ids; and the wrapper's dispatch rules.

Tolerance: rtol 2e-5 on the loss and metrics and rtol 2e-4 on each gradient
entry, those of the JAX package's own kernel-vs-XLA test (tests/test_ops_t.py),
with the gradient's atol 2e-7 widened by 1e-5 of the leaf's largest entry.
The two sides sum 256-512 rows in other orders (XLA's dots against
PyTorch's CPU products), so an entry that is a cancelling sum differs by a
few 1e-7 while the leaf runs to 0.3: with atol 2e-7 alone, 1 to 3 of the
53,125 entries fail by up to 2.1x. Both sides are then equally close to a
float64 evaluation of the same loss (within 6.4e-6 of the leaf's largest
entry), which `test_plain_matches_float64` pins."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.ops.ppo_fused import pack_aux
from autonomous_quadrotor_environment_tpu.ops.ppo_fused_t import fused_ppo_grad_t as jgrad_t
from autonomous_quadrotor_environment_tpu.ops.rollout_fused import transpose_leaves as jtranspose
from autonomous_quadrotor_environment_tpu_torch.agents.networks import LEAVES, ActorCritic
from autonomous_quadrotor_environment_tpu_torch.ops import ppo_fused_t as tpf
from torch_parity import n, t

T_STEPS, B, TILE = 4, 128, 64
STD, CLIP, ENT = 0.1, 0.2, 0.006


def _data(hidden, seed=0):
    """Seeded numpy rows in the transposed (T, F, B) layout and flax params."""
    rng = np.random.default_rng(seed)
    rows = T_STEPS * B
    obs = (rng.standard_normal((rows, 75)) * 0.3).astype(np.float32)
    actions = (rng.standard_normal((rows, 4)) * 0.2).astype(np.float32)
    old_lp = (rng.standard_normal((rows, 4)) * 0.1 - 1.0).astype(np.float32)
    rets = rng.standard_normal(rows).astype(np.float32)
    advs = rng.standard_normal(rows).astype(np.float32)
    aux = np.asarray(pack_aux(jnp.asarray(actions), jnp.asarray(old_lp),
                              jnp.asarray(rets), jnp.asarray(advs)))
    # Flat row t * B + b -> (T, F, B).
    to_t = lambda x: np.ascontiguousarray(np.moveaxis(x.reshape(T_STEPS, B, -1), 2, 1))
    params = JActorCritic(hidden=hidden, action_std=STD).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 75))
    )
    params = jax.tree.map(np.asarray, params)
    return to_t(obs), to_t(aux), params


def _jax(params, obs_t, aux_t, blocks):
    loss, met, grads = jgrad_t(
        params, jtranspose(params), jnp.asarray(obs_t), jnp.asarray(aux_t),
        jnp.asarray(blocks, jnp.int32), tile=TILE, action_std=STD, clip_eps=CLIP,
        entropy_coef=ENT, interpret=True,
    )
    p = grads["params"]
    # flax (in, out) kernels -> (out, in), as the port returns them.
    leaves = [np.asarray(p[h][d][k]) for h, d, k in LEAVES]
    leaves = [g.T if g.ndim == 2 else g for g in leaves]
    return float(loss), {k: float(v) for k, v in met.items()}, leaves


BLOCK_SETS = {
    "shuffled_subset": [1, 4, 6, 3],   # 4 of the 8 blocks, out of order
    "every_block": list(range(8)),
}


@pytest.mark.parametrize("hidden", [128, 32])
@pytest.mark.parametrize("which", sorted(BLOCK_SETS))
def test_plain_matches_jax_kernel(hidden, which):
    obs_t, aux_t, params = _data(hidden)
    blocks = BLOCK_SETS[which]
    loss_j, met_j, grads_j = _jax(params, obs_t, aux_t, blocks)

    model = ActorCritic.from_flax(params, action_std=STD)
    loss_t, met_t, grads_t = tpf.ppo_grad_t_plain(
        model, t(obs_t), t(aux_t), torch.tensor(blocks, dtype=torch.int32), tile=TILE,
        action_std=STD, clip_eps=CLIP, entropy_coef=ENT,
    )
    np.testing.assert_allclose(float(loss_t), loss_j, rtol=2e-5)
    for key, want in met_j.items():
        np.testing.assert_allclose(float(met_t[key]), want, rtol=2e-5, err_msg=key)
    assert len(grads_t) == 12
    for (name, gt, gj) in zip(LEAVES, grads_t, grads_j):
        assert tuple(gt.shape) == gj.shape, name
        assert_leaf_close(n(gt), gj, str(name))


def assert_leaf_close(got, want, name):
    atol = 2e-7 + 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=atol, err_msg=name)


@pytest.mark.parametrize("which", sorted(BLOCK_SETS))
def test_plain_matches_float64(which):
    """The f32 plain version and JAX's kernel both agree with a float64
    evaluation of the plain version to 1e-5 of each leaf's largest entry."""
    obs_t, aux_t, params = _data(32)
    blocks = torch.tensor(BLOCK_SETS[which])
    kw = dict(tile=TILE, action_std=STD, clip_eps=CLIP, entropy_coef=ENT)
    _, _, grads_j = _jax(params, obs_t, aux_t, BLOCK_SETS[which])
    _, _, grads_t = tpf.ppo_grad_t_plain(
        ActorCritic.from_flax(params, action_std=STD), t(obs_t), t(aux_t), blocks, **kw
    )
    _, _, grads_d = tpf.ppo_grad_t_plain(
        ActorCritic.from_flax(params, action_std=STD).double(),
        t(obs_t).double(), t(aux_t).double(), blocks, **kw,
    )
    for name, gt, gj, gd in zip(LEAVES, grads_t, grads_j, grads_d):
        scale = np.abs(n(gd)).max()
        assert np.abs(n(gt) - n(gd)).max() <= 1e-5 * scale, name
        assert np.abs(gj - n(gd)).max() <= 1e-5 * scale, name


def test_inputs_reach_both_sides_of_the_clip():
    """The data above has rows inside the clip band and on both sides of it,
    so the clip-tie branch of the backward is exercised."""
    obs_t, aux_t, params = _data(128)
    model = ActorCritic.from_flax(params, action_std=STD)
    rows = tpf._gather_rows(t(obs_t), torch.arange(8), TILE)
    aux = tpf._gather_rows(t(aux_t), torch.arange(8), TILE)
    with torch.no_grad():
        mean = model(rows)[0]
    z = (aux[:, 0:4] - mean) / STD
    lp = -0.5 * (z**2).sum(1) - 4 * (np.log(STD) + 0.5 * np.log(2 * np.pi))
    ratio = torch.exp(lp - aux[:, 4])
    assert (ratio < 1 - CLIP).any() and (ratio > 1 + CLIP).any()
    assert ((ratio > 1 - CLIP) & (ratio < 1 + CLIP)).any()


def test_leaves_and_model_give_the_same_gradients():
    obs_t, aux_t, params = _data(32, seed=3)
    model = ActorCritic.from_flax(params, action_std=STD)
    blocks = torch.tensor([5, 0, 2], dtype=torch.int32)
    kw = dict(tile=TILE, action_std=STD, clip_eps=CLIP, entropy_coef=ENT)
    loss_a, _, ga = tpf.fused_ppo_grad_t(model, t(obs_t), t(aux_t), blocks, **kw)
    leaves = [p.detach().clone() for l in model.linears() for p in (l.weight, l.bias[:, None])]
    loss_b, _, gb = tpf.fused_ppo_grad_t(leaves, t(obs_t), t(aux_t), blocks, **kw)
    assert float(loss_a) == float(loss_b)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)
    # The model's own .grad is left alone.
    assert all(p.grad is None for p in model.parameters())


def test_gather_rows_follows_the_block_ids():
    x = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)  # T=2, F=3, B=8
    rows = tpf._gather_rows(x, torch.tensor([3, 0]), tile=2)  # 4 blocks per t
    # Block 3 is t=0, envs 6:8; block 0 is t=0, envs 0:2.
    want = torch.cat([x[0, :, 6:8].T, x[0, :, 0:2].T])
    assert torch.equal(rows, want)
    rows = tpf._gather_rows(x, torch.tensor([5]), tile=2)  # t=1, envs 2:4
    assert torch.equal(rows, x[1, :, 2:4].T)


def test_supports_and_refusals():
    obs_t, aux_t, params = _data(128)
    model = ActorCritic.from_flax(params, action_std=STD)
    leaves = tpf._leaves(model)
    ob = t(obs_t)
    assert tpf.supports(ob, leaves, 64)
    assert not tpf.supports(ob, leaves, 48)           # not a multiple of 32
    assert not tpf.supports(ob, leaves, 256)          # does not divide B
    small = tpf._leaves(ActorCritic(hidden=32))
    assert not tpf.supports(ob, small, 64)
    # A tensor on neither the CPU nor a CUDA card is refused, not computed.
    with pytest.raises(ValueError):
        tpf.fused_ppo_grad_t(
            leaves, ob.to("meta"), t(aux_t).to("meta"), torch.zeros(1, dtype=torch.int32),
            tile=64, action_std=STD, clip_eps=CLIP, entropy_coef=ENT,
        )


def test_pack_layout():
    """The kernels' weight pack at the offsets `ops.ppo_fused_t` mirrors from
    the header: per head W1 (out, in) with inputs 75-79 zero, one copy of W2
    (out, in), W3 padded to 4 rows, b1, b2, b3 padded; the pads are zero."""
    model = ActorCritic(hidden=128)
    leaves = tpf._leaves(model)
    pack = tpf._pack(leaves)
    h, o, k1 = 128, 75, tpf.K1
    assert pack.shape == (2, k1 * h + h * h + 4 * h + 2 * h + 4) == (2, tpf.PACK)
    for head in range(2):
        w1, b1, w2, b2, w3, b3 = leaves[6 * head: 6 * head + 6]
        p = pack[head]
        w1p = p[tpf.P_W1: tpf.P_W2].view(h, k1)
        assert torch.equal(w1p[:, :o], w1) and not w1p[:, o:].any()
        assert torch.equal(p[tpf.P_W2: tpf.P_W3].view(h, h), w2)
        w3p = p[tpf.P_W3: tpf.P_B1].view(4, h)
        assert torch.equal(w3p[: w3.shape[0]], w3) and not w3p[w3.shape[0]:].any()
        assert torch.equal(p[tpf.P_B1: tpf.P_B2], b1[:, 0])
        assert torch.equal(p[tpf.P_B2: tpf.P_B3], b2[:, 0])
        assert torch.equal(p[tpf.P_B3: tpf.P_B3 + w3.shape[0]], b3[:, 0])
        assert not p[tpf.P_B3 + w3.shape[0]:].any()


def _header_constants() -> dict:
    """The `constexpr int` constants of `csrc/ppo_grad.cuh`, evaluated in
    order (those that are not plain integer arithmetic are skipped)."""
    import os
    import re

    path = os.path.join(os.path.dirname(tpf.__file__), "csrc", "ppo_grad.cuh")
    consts = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", open(path).read()):
        try:
            consts[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(consts))
        except (NameError, SyntaxError, TypeError):
            pass
    return consts


def test_header_declares_the_mirrored_layouts():
    """The pack offsets mirrored in `ops.ppo_fused_t` are the header's; the
    (2, G, ACCS) partial layout that the reductions and B4's Adam step read
    is the one they have always read (dW1 rows of 76, then dW2, dW3, b1, b2,
    b3, 4 metrics); the flat output holds `split_out`'s leaves; the shared
    memory fits a CTA."""
    c = _header_constants()
    for name in ("P_W1", "P_W2", "P_W3", "P_B1", "P_B2", "P_B3", "PACK", "K1", "CHUNK"):
        assert c[name] == getattr(tpf, name), name
    assert (c["OBS"], c["H"], c["NA"]) == (tpf.OBS, tpf.HIDDEN, tpf.ACT)
    assert [c[k] for k in ("A_W1", "A_W2", "A_W3", "A_B1", "A_B2", "A_B3", "ACC", "ACCS")] == [
        0, 9728, 26112, 26624, 26752, 26880, 26884, 26888]
    sizes = [math.prod(s) for s in tpf._leaf_shapes(128)]
    assert c["O_ACTOR"] == sum(sizes[:6]) and c["O_CRITIC"] == sum(sizes[6:])
    assert c["N_OUT"] == sum(sizes) + 3
    assert c["SMEM_FLOATS"] * 4 <= 232448  # a CTA's shared memory on an H100


def test_split_out_follows_the_leaf_order():
    out = torch.arange(53128, dtype=torch.float32)
    grads, actor_sum, critic_sum, rmax = tpf.split_out(out)
    assert [tuple(g.shape) for g in grads] == tpf._leaf_shapes(128)
    assert torch.equal(torch.cat([g.reshape(-1) for g in grads]), out[:-3])
    assert (actor_sum.item(), critic_sum.item(), rmax.item()) == (53125.0, 53126.0, 53127.0)


def test_entropy_constant_matches_the_gaussian_head():
    from autonomous_quadrotor_environment_tpu_torch.agents.networks import DiagGaussian

    d = DiagGaussian(torch.zeros(3, 4), torch.tensor(np.log(STD), dtype=torch.float32))
    np.testing.assert_allclose(
        float(d.entropy().sum(-1).mean()), tpf.entropy_const(STD), rtol=1e-6
    )
