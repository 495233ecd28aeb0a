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
import re

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
from autonomous_quadrotor_environment_tpu_torch.ops import rollout_fused as trf
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
    assert tpf.supports(ob, leaves, 8) and tpf.supports(ob, leaves, 16)  # any tile dividing B
    assert not tpf.supports(ob, leaves, 24)          # does not divide B
    assert not tpf.supports(ob, leaves, 256)          # does not divide B
    small = tpf._leaves(ActorCritic(hidden=32))
    assert tpf.supports(ob, small, 64)                # any width up to 256
    for hidden in (257, 1024, 1025):                  # the wide kernels, any width
        assert tpf.supports(ob, tpf._leaves(ActorCritic(hidden=hidden)), 64)
    # A tensor on neither the CPU nor a CUDA card is refused, not computed.
    with pytest.raises(ValueError):
        tpf.fused_ppo_grad_t(
            leaves, ob.to("meta"), t(aux_t).to("meta"), torch.zeros(1, dtype=torch.int32),
            tile=64, action_std=STD, clip_eps=CLIP, entropy_coef=ENT,
        )


@pytest.mark.parametrize("hidden, obs", [(128, 75), (20, 75), (200, 60)])
def test_pack_layout(hidden, obs):
    """The kernels' weight pack at the offsets the header declares
    (`rollout_fused.pack_offsets`), at the instantiated width H >= hidden
    and depth K1 >= obs: per head W1 (out, in) with inputs obs.. and units
    hidden.. zero, one copy of W2 (out, in) zero-padded, W3 padded to 4 rows,
    b1, b2, b3 padded; the pads are zero."""
    model = ActorCritic(hidden=hidden, obs_dim=obs)
    leaves = tpf._leaves(model)
    pack = tpf._pack(leaves)
    h, k1, n = trf.kernel_width(hidden), tpf.kernel_depth(hidden, obs), hidden
    lay = trf.pack_offsets(h, k1)
    assert pack.shape == (2, k1 * h + h * h + 4 * h + 2 * h + 4) == (2, lay["PACK"])
    for head in range(2):
        w1, b1, w2, b2, w3, b3 = leaves[6 * head: 6 * head + 6]
        p = pack[head]
        w1p = p[lay["P_W1"]: lay["P_W2"]].view(h, k1)
        assert torch.equal(w1p[:n, :obs], w1) and not w1p[:, obs:].any() and not w1p[n:].any()
        w2p = p[lay["P_W2"]: lay["P_W3"]].view(h, h)
        assert torch.equal(w2p[:n, :n], w2) and not w2p[n:].any() and not w2p[:, n:].any()
        w3p = p[lay["P_W3"]: lay["P_B1"]].view(4, h)
        assert torch.equal(w3p[: w3.shape[0], :n], w3) and not w3p[w3.shape[0]:].any()
        assert not w3p[:, n:].any()
        assert torch.equal(p[lay["P_B1"]: lay["P_B1"] + n], b1[:, 0])
        assert torch.equal(p[lay["P_B2"]: lay["P_B2"] + n], b2[:, 0])
        assert not p[lay["P_B1"] + n: lay["P_B2"]].any()
        assert not p[lay["P_B2"] + n: lay["P_B3"]].any()
        assert torch.equal(p[lay["P_B3"]: lay["P_B3"] + w3.shape[0]], b3[:, 0])
        assert not p[lay["P_B3"] + w3.shape[0]:].any()


def _c_to_python(expr: str) -> str:
    """A C++ constant expression of the header as Python: ternaries (split
    at their top-level ``?`` and ``:``), ``&&``, ``||``, ``!`` and ``/``."""
    depth, q = 0, -1
    for i, ch in enumerate(expr):
        depth += (ch == "(") - (ch == ")")
        if depth == 0 and ch == "?" and q < 0:
            q = i
        elif depth == 0 and ch == ":" and q >= 0:
            return (f"(({_c_to_python(expr[q + 1:i])}) if ({_c_to_python(expr[:q])}) "
                    f"else ({_c_to_python(expr[i + 1:])}))")
    if expr.strip().startswith("(") and expr.strip().endswith(")") and "?" in expr:
        inner = expr.strip()[1:-1]
        if inner.count("(") == inner.count(")"):
            return f"({_c_to_python(inner)})"
    expr = expr.replace("&&", " and ").replace("||", " or ").replace("/", "//")
    expr = re.sub(r"!(\w+)", r"(not \1)", expr)
    return re.sub(r"!(?!=)", " not ", expr).replace("true", "True").replace("false", "False")


def _header_constants(hidden: int = 128, obs: int = 75) -> dict:
    """The `constexpr int` and `constexpr bool` constants of
    `csrc/ppo_grad.cuh` (after those of `csrc/ppo_common.cuh`, which it
    includes) at the instantiation the build gives a model of ``hidden``
    units and ``obs`` inputs (its -DAQE_* defines), evaluated in order
    (those that are not plain arithmetic are skipped)."""
    import os

    csrc = os.path.join(os.path.dirname(tpf.__file__), "csrc")
    consts = {f"AQE_{k}": v for k, v in tpf.library(hidden, obs, "f32")}
    text = "".join(open(os.path.join(csrc, f)).read() for f in ("ppo_common.cuh", "ppo_grad.cuh"))
    found = re.findall(r"constexpr (?:int|bool) (\w+) = ([^;]+);", text)
    for name, expr in found:
        try:
            consts[name] = int(eval(f"({_c_to_python(expr)})", {"__builtins__": {}}, dict(consts)))
        except (NameError, SyntaxError, TypeError):
            pass
    return consts


def test_header_declares_the_mirrored_layouts():
    """What the wrappers mirror of the header, the weight pack's width,
    depth and offsets, is the header's at every width it is built for (up
    to 128; wider models run on `ppo_grad_wide.cuh`) and at narrow and wide
    obs; each instantiation fits a CTA's shared memory, two weight-gradient
    slices share a walk where one CTA's registers do not hold dW2 and dW1,
    and the obs that the staged layout does not hold go to the wide one
    (any obs width runs); at the trainer's instantiation the (2, G, ACCS)
    partial layout that the reductions and B4's Adam step read is the one
    they have always read (dW1 rows of 76, then dW2, dW3, b1, b2, b3, 4
    metrics)."""
    wide = {(128, 300), (100, 300), (64, 450), (20, 1500)}
    two_slices = {(128, 90), (100, 200)}
    for hidden, obs in [(128, 75), (20, 75), (64, 60), (128, 90), (100, 200), (32, 15),
                        *sorted(wide)]:
        c = _header_constants(hidden, obs)
        h, k1 = trf.kernel_width(hidden), tpf.kernel_depth(hidden, obs)
        lay = trf.pack_offsets(h, k1)
        for name in ("P_W1", "P_W2", "P_W3", "P_B1", "P_B2", "P_B3", "PACK"):
            assert c[name] == lay[name], (hidden, obs, name)
        assert (c["H"], c["K1"], c["OBS"], c["NA"], c["CHUNK"]) == (h, k1, obs, tpf.ACT,
                                                                   tpf.CHUNK)
        assert c["SMEM_FLOATS"] * 4 <= 232448, (hidden, obs)
        assert c["WIDE"] == ((hidden, obs) in wide), (hidden, obs)
        assert c["NS"] == 1 + ((hidden, obs) in two_slices), (hidden, obs)
    c = _header_constants()
    assert [c[k] for k in ("A_W1", "A_W2", "A_W3", "A_B1", "A_B2", "A_B3", "ACC", "ACCS")] == [
        0, 9728, 26112, 26624, 26752, 26880, 26884, 26888]
    assert c["RESIDENT_W"] == 1 and c["NS"] == 1 and c["SMEM_FLOATS"] * 4 == 230480
    assert c["WIDE"] == 0 and tpf.kernel_depth(128, 75) == 80


def test_split_out_follows_the_leaf_order():
    out = torch.arange(53128, dtype=torch.float32)
    grads, actor_sum, critic_sum, rmax = tpf.split_out(out)
    assert [tuple(g.shape) for g in grads] == tpf._leaf_shapes(128)
    assert torch.equal(torch.cat([g.reshape(-1) for g in grads]), out[:-3])
    assert (actor_sum.item(), critic_sum.item(), rmax.item()) == (53125.0, 53126.0, 53127.0)
    # At another width and obs width: the model's own leaves, not the padded ones.
    shapes = tpf._leaf_shapes(20, obs=60)
    n = sum(math.prod(s) for s in shapes)
    grads, actor_sum, _, rmax = tpf.split_out(torch.arange(n + 3.0), 20, 60)
    assert [tuple(g.shape) for g in grads] == shapes
    assert (actor_sum.item(), rmax.item()) == (n, n + 2)


def test_entropy_constant_matches_the_gaussian_head():
    from autonomous_quadrotor_environment_tpu_torch.agents.networks import DiagGaussian

    d = DiagGaussian(torch.zeros(3, 4), torch.tensor(np.log(STD), dtype=torch.float32))
    np.testing.assert_allclose(
        float(d.entropy().sum(-1).mean()), tpf.entropy_const(STD), rtol=1e-6
    )
