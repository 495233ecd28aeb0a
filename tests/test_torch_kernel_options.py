"""The kernel options beyond the trainer's defaults, on the CPU, against the
JAX package: bf16 products in B2-B4 (`PPOConfig.fused_compute="bf16"`),
hidden widths 16, 256, 320 and 1100 (B1-B4; 320 and 1100 on the card's
wide design, 1100 above the 1024 units it once stopped at), obs 60
(hist_t=4) in B3/B4, and B2 tiles 8 and 24; and, in pure Python, the
widths the card's kernels run a model on and the one width limit left.
Each case feeds numpy-seeded inputs to the JAX kernel run in interpret
mode (as tests/test_ops.py runs it) and to the port's plain version, which
is what the card's kernels are held against; and one whole train step with
bf16 products on each branch against JAX's.

Tolerances:
- bf16 gradients: loss and metrics within rtol 1e-4, each leaf within a
  relative Frobenius error of 1e-3. Both sides round the same operands to
  bf16 and sum in f32, so only the f32 sum order differs (measured: 8e-8
  on the loss, 2e-7 on a metric, 2.6e-7 on a leaf, against 4.7e-3 and
  6.4e-3 between the bf16 and the f32 gradients);
- widths 16, 256, 320 and 1100 (B4's new params and moments too, from a
  warmed state), obs 60 and the tiles: the step-math tolerance of `torch_parity`
  (rtol 2e-4, atol 2e-5), on each gradient entry and the rollout's outputs;
- the bf16 train steps: JAX's own bf16 bounds (tests/test_ops.py:183-191),
  the loss within rtol 2e-2 and the parameters within 5 lr;
- the padding identity: the loss and metrics bit for bit, every gradient
  within 4 ulp of its leaf's largest entry, the padded entries exactly 0
  (the CPU's own sums are not bit-stable across widths: torch's column
  sums behind the bias gradients and its 1-row products vectorize a 20-
  and a 32-wide tensor differently; measured up to 2 ulp apart, the
  weight gradients of the two wide products bit-equal).

The two whole train steps take most of this file's time (about 14 s each
in a run of the whole file, JAX compiling its interpret-mode kernels); the
rest about 70 s, of it 9 s the four cases at hidden 320 (B2 3.8 s, B3 1.2,
B1 1.9, B4 2.1 on one pytest worker on the CPU) and 20 s the four at 1100
(B1 10.0 s, B2 6.3, B4 2.2, B3 1.2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu import config as jcfg
from autonomous_quadrotor_environment_tpu.agents import PPOTrainState as JPPOTrainState
from autonomous_quadrotor_environment_tpu.agents import make_train_step as jmake_train_step
from autonomous_quadrotor_environment_tpu.agents.ppo import make_optimizer as jmake_optimizer
from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.envs import hover as jhover
from autonomous_quadrotor_environment_tpu.ops import ppo_fused as jpf
from autonomous_quadrotor_environment_tpu.ops import rollout_fused as jrf
from autonomous_quadrotor_environment_tpu.ops.ppo_fused_t import fused_ppo_grad_t as jgrad_t
from autonomous_quadrotor_environment_tpu_torch import config as tcfg
from autonomous_quadrotor_environment_tpu_torch.agents import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.agents.networks import LEAVES, ActorCritic
from autonomous_quadrotor_environment_tpu_torch.ops import ppo_fused as tpr
from autonomous_quadrotor_environment_tpu_torch.ops import ppo_fused_t as tpf
from autonomous_quadrotor_environment_tpu_torch.ops import rollout_fused as trf
from torch_parity import (
    ATOL,
    RTOL,
    assert_params_close,
    jax_perms,
    jax_rollout_draws,
    n,
    port_env_config,
    port_states,
    t,
)

STD, CLIP, ENT = 0.1, 0.2, 0.006
KW = dict(action_std=STD, clip_eps=CLIP, entropy_coef=ENT)
LR, B1, B2 = 5e-4, 0.9, 0.999
T_STEPS, B_ENVS = 4, 48  # the transposed batch: tiles 8, 16, 24 and 48 divide B
ROWS, TILE = 96, 8       # the row-major batch
ENV = jcfg.EnvConfig()
# Jitted once for the module: each new function object would compile again.
_reset = jax.jit(jax.vmap(lambda k: jhover.reset(k, ENV)))
_reset_pool = jax.jit(jax.vmap(jax.vmap(lambda k: jhover.reset(k, ENV))))
_twin = jax.jit(lambda *a: jrf.rollout_twin(*a, C=jrf._scalars(ENV), action_std=STD))


def _params(hidden, obs_dim=75, seed=0):
    params = JActorCritic(hidden=hidden, action_std=STD).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)))
    return jax.tree.map(np.asarray, params)


def _rows(n_rows, obs_dim, seed):
    """Seeded numpy obs (n, obs_dim) and aux (n, 8), ratios on both sides of
    the clip band."""
    rng = np.random.default_rng(seed)
    obs = (rng.standard_normal((n_rows, obs_dim)) * 0.3).astype(np.float32)
    actions = (rng.standard_normal((n_rows, 4)) * 0.2).astype(np.float32)
    old_lp = (rng.standard_normal((n_rows, 4)) * 0.1 + 0.4).astype(np.float32)
    rets = rng.standard_normal(n_rows).astype(np.float32)
    advs = rng.standard_normal(n_rows).astype(np.float32)
    aux = np.asarray(jpf.pack_aux(jnp.asarray(actions), jnp.asarray(old_lp), jnp.asarray(rets),
                                  jnp.asarray(advs)))
    return obs, aux


def _transposed(obs, aux):
    """Flat rows t * B + b -> (T, F, B)."""
    to_t = lambda x: np.ascontiguousarray(np.moveaxis(x.reshape(T_STEPS, B_ENVS, -1), 2, 1))
    return to_t(obs), to_t(aux)


def _flat(tree):
    """A flax tree -> the 12 leaves in leaf order, (out, in) like the port's."""
    p = tree["params"]
    leaves = [np.asarray(p[h][d][k]) for h, d, k in LEAVES]
    return [x.T if x.ndim == 2 else x for x in leaves]


def _rel_fro(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _grads(kernel, params, obs, aux, blocks, tile, compute):
    """(jax, port) loss, metrics and leaves of B2 ("b2", transposed rows) or
    B3 ("b3", row-major rows) at ``compute``."""
    model = ActorCritic.from_flax(params, action_std=STD)
    kw = dict(tile=tile, compute_dtype=compute, **KW)
    if kernel == "b2":
        jl, jm, jg = jgrad_t(params, jrf.transpose_leaves(params), jnp.asarray(obs),
                             jnp.asarray(aux), jnp.asarray(blocks, jnp.int32), interpret=True,
                             **kw)
        tl, tm, tg = tpf.ppo_grad_t_plain(model, t(obs), t(aux), torch.tensor(blocks), **kw)
    else:
        jl, jm, jg = jpf.fused_ppo_grad(params, jnp.asarray(obs), jnp.asarray(aux),
                                        jnp.asarray(blocks, jnp.int32), interpret=True, **kw)
        tl, tm, tg = tpr.ppo_grad_plain(model, t(obs), t(aux), torch.tensor(blocks), **kw)
    return (float(jl), {k: float(v) for k, v in jm.items()}, _flat(jg)), \
        (float(tl), {k: float(v) for k, v in tm.items()}, [n(g) for g in tg])


def _assert_metrics(jax_side, port_side, rtol):
    np.testing.assert_allclose(port_side[0], jax_side[0], rtol=rtol)
    for key, want in jax_side[1].items():
        np.testing.assert_allclose(port_side[1][key], want, rtol=rtol, err_msg=key)


def _assert_leaves_step_math(jax_side, port_side):
    for name, g, w in zip(LEAVES, port_side[2], jax_side[2]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=str(name))


@pytest.mark.parametrize("kernel", ["b2", "b3"])
def test_bf16_grad_matches_jax(kernel):
    """B2's and B3's plain versions with bf16 products against the JAX
    kernels with compute_dtype="bf16"; and the bf16 gradient is another one
    than the f32 gradient (the rounding is there)."""
    params = _params(32)
    obs, aux = _rows(ROWS if kernel == "b3" else T_STEPS * B_ENVS, 75, 1)
    if kernel == "b2":
        obs, aux = _transposed(obs, aux)
        blocks, tile = [5, 0, 9, 2, 11, 7], 16
    else:
        blocks, tile = [3, 0, 7, 5, 1, 10], TILE
    jax_side, port_side = _grads(kernel, params, obs, aux, blocks, tile, "bf16")
    _assert_metrics(jax_side, port_side, 1e-4)
    for name, g, w in zip(LEAVES, port_side[2], jax_side[2]):
        assert _rel_fro(g, w) <= 1e-3, name
    plain = tpf.ppo_grad_t_plain if kernel == "b2" else tpr.ppo_grad_plain
    _, _, f32 = plain(ActorCritic.from_flax(params, action_std=STD), t(obs), t(aux),
                      torch.tensor(blocks), tile=tile, **KW)
    assert max(_rel_fro(a, n(b)) for a, b in zip(port_side[2], f32)) > 1e-3


def test_bf16_grad_adam_matches_jax():
    """B4's plain version with bf16 products (the Adam step in f32) against
    JAX's `fused_ppo_grad_adam` with compute_dtype="bf16", from a warmed
    Adam state: new params, mu and nu within 1e-3 relative Frobenius."""
    params = _params(32, seed=2)
    obs, aux = _rows(ROWS, 75, 2)
    blocks = np.asarray([3, 0, 7, 5, 1, 10], np.int32)
    rng = np.random.default_rng(1)
    mu = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32), params)
    nu = jax.tree.map(lambda p: rng.uniform(1e-5, 1e-3, p.shape).astype(np.float32), params)
    jl, jm, p_j, mu_j, nu_j, _ = jpf.fused_ppo_grad_adam(
        params, mu, nu, jnp.asarray(3, jnp.int32), jnp.asarray(obs), jnp.asarray(aux),
        jnp.asarray(blocks), tile=TILE, lr=LR, adam_b1=B1, adam_b2=B2, interpret=True,
        compute_dtype="bf16", **KW)
    model = ActorCritic.from_flax(params, action_std=STD)
    tl, tm, p_t, mu_t, nu_t, count = tpr.ppo_grad_adam_plain(
        model, [t(x) for x in _flat(mu)], [t(x) for x in _flat(nu)], 3, t(obs), t(aux),
        torch.from_numpy(blocks), tile=TILE, lr=LR, b1=B1, b2=B2, compute_dtype="bf16", **KW)
    assert count == 4
    _assert_metrics((float(jl), {k: float(v) for k, v in jm.items()}),
                    (float(tl), {k: float(v) for k, v in tm.items()}), 1e-4)
    for what, got, want in (("params", p_t, p_j), ("mu", mu_t, mu_j), ("nu", nu_t, nu_j)):
        for name, g, w in zip(LEAVES, got, _flat(want)):
            assert _rel_fro(n(g), w) <= 1e-3, (what, name)


@pytest.mark.parametrize("hidden", [16, 256, 320, 1100])
@pytest.mark.parametrize("kernel", ["b2", "b3"])
def test_width_grad_matches_jax(kernel, hidden):
    """The gradient of the fully fused step (B2) and of the row-major step
    (B3) at hidden 16, 256, 320 and 1100, which the card runs zero-padded on
    its 32-wide instantiation and on the wide design (at 256, 384 and
    1152)."""
    params = _params(hidden, seed=3)
    obs, aux = _rows(ROWS if kernel == "b3" else T_STEPS * B_ENVS, 75, 3)
    if kernel == "b2":
        obs, aux = _transposed(obs, aux)
        blocks, tile = [2, 1, 3], 48
    else:
        blocks, tile = [3, 0, 7, 5, 1, 10], TILE
    jax_side, port_side = _grads(kernel, params, obs, aux, blocks, tile, "f32")
    _assert_metrics(jax_side, port_side, RTOL)
    _assert_leaves_step_math(jax_side, port_side)


@pytest.mark.parametrize("hidden", [16, 256, 320, 1100])
def test_width_rollout_matches_jax(hidden):
    """The rollout of the fully fused step (B1's plain version) at hidden
    16, 256, 320 and 1100 (the wide rollout's, zero-padded to 384 and 1152)
    against the
    JAX package's `rollout_twin`, 8 steps from JAX's reset states, noise and
    pool."""
    b, steps = 16, 8
    keys = jax.random.split(jax.random.PRNGKey(4), b + 2)
    js = _reset(keys[:b])
    wT = jrf.transpose_leaves(_params(hidden, seed=4))
    noise = jax.random.normal(keys[b], (steps, 4, b))
    pool = jax.vmap(jrf.pack_env_state)(_reset_pool(jax.random.split(keys[b + 1], (2, b))))
    s0 = jrf.pack_env_state(js)
    s_j, outs_j = _twin(s0, noise, pool, wT)
    s_t, obs_t, misc_t = trf.rollout_plain(t(s0), t(noise), t(pool), [t(w) for w in wT],
                                           trf._scalars(port_env_config(ENV)), STD)
    obs_j, act_j, lp_j, val_j, rew_j, done_j, _ = outs_j
    for got, want in ((obs_t, obs_j), (misc_t[:, 0:4], act_j), (misc_t[:, 4:8], lp_j),
                      (misc_t[:, 8:9], val_j), (misc_t[:, 9:10], rew_j), (s_t, s_j)):
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(n(misc_t[:, 10:11]), np.asarray(done_j))


@pytest.mark.parametrize("hidden", [320, 1100])
def test_width_grad_adam_matches_jax(hidden):
    """B4's plain version at hidden 320 and 1100 (the wide design's,
    zero-padded to 384 and 1152) against JAX's `fused_ppo_grad_adam`, from a
    warmed Adam state: the new params, mu and nu at the step-math
    tolerance."""
    params = _params(hidden, seed=6)
    obs, aux = _rows(ROWS, 75, 6)
    blocks = np.asarray([3, 0, 7, 5, 1, 10], np.int32)
    rng = np.random.default_rng(6)
    mu = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32), params)
    nu = jax.tree.map(lambda p: rng.uniform(1e-5, 1e-3, p.shape).astype(np.float32), params)
    jl, jm, p_j, mu_j, nu_j, _ = jpf.fused_ppo_grad_adam(
        params, mu, nu, jnp.asarray(3, jnp.int32), jnp.asarray(obs), jnp.asarray(aux),
        jnp.asarray(blocks), tile=TILE, lr=LR, adam_b1=B1, adam_b2=B2, interpret=True, **KW)
    model = ActorCritic.from_flax(params, action_std=STD)
    tl, tm, p_t, mu_t, nu_t, count = tpr.ppo_grad_adam_plain(
        model, [t(x) for x in _flat(mu)], [t(x) for x in _flat(nu)], 3, t(obs), t(aux),
        torch.from_numpy(blocks), tile=TILE, lr=LR, b1=B1, b2=B2, **KW)
    assert count == 4
    _assert_metrics((float(jl), {k: float(v) for k, v in jm.items()}),
                    (float(tl), {k: float(v) for k, v in tm.items()}), RTOL)
    for what, got, want in (("params", p_t, p_j), ("mu", mu_t, mu_j), ("nu", nu_t, nu_j)):
        for name, g, w in zip(LEAVES, got, _flat(want)):
            np.testing.assert_allclose(n(g), w, rtol=RTOL, atol=ATOL, err_msg=f"{what} {name}")


def test_kernel_width_pads_every_wide_width():
    """Every width from 1025 to 4096 runs on the next multiple of 128, which
    holds it: no width is refused."""
    for hidden in range(1025, 4097):
        width = trf.kernel_width(hidden)
        assert width % 128 == 0 and hidden <= width < hidden + 128, hidden


def test_check_fits_names_the_bytes_of_a_width_past_the_offsets():
    """The one width limit left: an array past the kernels' 32-bit offsets
    (the gradients' flat output at about 2 hidden^2 floats), refused with
    the bytes it needs; 4096 and 32,000 pass."""
    for hidden in (1100, 4096, 32000):
        tpf.check_fits(hidden, 75)
    with pytest.raises(ValueError, match=r"needs \d+ bytes of gradient output"):
        tpf.check_fits(33000, 75)
    with pytest.raises(ValueError, match=r"needs \d+ bytes of weight pack"):
        trf.check_offsets("weight pack a head", trf.pack_offsets(46400, 96)["PACK"], 46400)


@pytest.mark.parametrize("adam", [False, True])
def test_obs60_rowmajor_matches_jax(adam):
    """B3 and B4 at obs 60 (hist_t=4), which the row-major branch sends to
    them, against JAX's kernels at obs 60."""
    params = _params(32, obs_dim=60, seed=5)
    obs, aux = _rows(ROWS, 60, 5)
    blocks = np.asarray([3, 0, 7, 5, 1, 10], np.int32)
    model = ActorCritic.from_flax(params, action_std=STD)
    if not adam:
        jax_side, port_side = _grads("b3", params, obs, aux, blocks, TILE, "f32")
        _assert_metrics(jax_side, port_side, RTOL)
        _assert_leaves_step_math(jax_side, port_side)
        return
    zeros = jax.tree.map(np.zeros_like, params)
    _, _, p_j, mu_j, _, _ = jpf.fused_ppo_grad_adam(
        params, zeros, zeros, jnp.asarray(0, jnp.int32), jnp.asarray(obs), jnp.asarray(aux),
        jnp.asarray(blocks), tile=TILE, lr=LR, adam_b1=B1, adam_b2=B2, interpret=True, **KW)
    z = [t(x) for x in _flat(zeros)]
    _, _, p_t, mu_t, _, _ = tpr.ppo_grad_adam_plain(
        model, z, z, 0, t(obs), t(aux), torch.from_numpy(blocks), tile=TILE, lr=LR, b1=B1,
        b2=B2, **KW)
    for name, g, w in zip(LEAVES, mu_t, _flat(mu_j)):
        np.testing.assert_allclose(n(g), w, rtol=RTOL, atol=ATOL, err_msg=str(name))
    # From empty moments a step is about lr sign(g): held at 5% of lr.
    for name, g, w in zip(LEAVES, p_t, _flat(p_j)):
        np.testing.assert_allclose(n(g), w, rtol=0, atol=LR * 0.05, err_msg=str(name))


@pytest.mark.parametrize("tile", [8, 24])
def test_b2_tiles_match_jax(tile):
    """B2 at env tiles 8 and 24, which `update_t_tile` gives (gcd of the
    shuffle block and B): a 64-row chunk then gathers blocks at several
    timesteps."""
    assert tppo.update_t_tile(tcfg.PPOConfig(shuffle_block=tile), T_STEPS, B_ENVS) == tile
    params = _params(32, seed=6)
    obs, aux = _transposed(*_rows(T_STEPS * B_ENVS, 75, 6))
    n_blocks = T_STEPS * B_ENVS // tile
    blocks = list(np.random.default_rng(6).permutation(n_blocks)[: n_blocks // 2 + 1])
    jax_side, port_side = _grads("b2", params, obs, aux, blocks, tile, "f32")
    _assert_metrics(jax_side, port_side, RTOL)
    _assert_leaves_step_math(jax_side, port_side)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_padding_identity(compute):
    """A hidden-20 model's gradients equal, bit for bit on the CPU, those of
    the same model zero-padded to hidden 32 (what the card's 32-wide
    instantiation computes), sliced; the padded rows and columns are exactly
    0, so Adam leaves them at 0."""
    torch.manual_seed(7)
    small = ActorCritic(hidden=20, action_std=STD)
    wide = ActorCritic(hidden=32, action_std=STD)
    with torch.no_grad():
        for a, b in zip(small.linears(), wide.linears()):
            b.weight.zero_()
            b.bias.zero_()
            b.weight[: a.weight.shape[0], : a.weight.shape[1]] = a.weight
            b.bias[: a.bias.shape[0]] = a.bias
    obs, aux = _rows(ROWS, 75, 7)
    blocks = torch.tensor([3, 0, 7, 5, 1, 10])
    kw = dict(tile=TILE, compute_dtype=compute, **KW)
    ls, ms, gs = tpr.ppo_grad_plain(small, t(obs), t(aux), blocks, **kw)
    lw, mw, gw = tpr.ppo_grad_plain(wide, t(obs), t(aux), blocks, **kw)
    assert torch.equal(ls, lw) and all(torch.equal(ms[k], mw[k]) for k in ms)
    for name, a, b in zip(LEAVES, gs, gw):
        sl = tuple(slice(0, s) for s in a.shape)
        ulp = float(np.spacing(np.float32(a.abs().max())))
        assert (a - b[sl]).abs().max() <= 4 * ulp, name
        pad = b.clone()
        pad[sl] = 0
        assert not pad.any(), name


@functools.lru_cache(maxsize=None)
def _jax_start(hidden, b):
    """What JAX's `ppo_init` makes from PRNGKey(0) at ENV: the params, the
    reset envs and the state's key, the envs through this module's jitted
    reset (compiled once for the module)."""
    k_model, k_envs, k_state = jax.random.split(jax.random.PRNGKey(0), 3)
    params = JActorCritic(hidden=hidden, action_std=STD).init(k_model, jnp.zeros((1, 75)))
    return params, _reset(jax.random.split(k_envs, b)), k_state


def _jax_step(ppo_kw, train_kw, steps, b, hidden):
    """One JAX train step from `ppo_init`'s state (`_jax_start`)."""
    jppo = jcfg.PPOConfig(**ppo_kw)
    jtrain = jcfg.TrainConfig(num_envs=b, rollout_steps=steps, network_size=hidden, **train_kw)
    jmodel = JActorCritic(hidden=hidden, action_std=jppo.action_std)
    tx = jmake_optimizer(jppo)
    params, env_states, key = _jax_start(hidden, b)
    jstate = JPPOTrainState(params=params, opt_state=tx.init(params), env_states=env_states,
                            key=key, update_i=jnp.zeros((), jnp.int32))
    jnew, mj = jax.jit(jmake_train_step(jmodel, tx, ENV, jppo, jtrain))(jstate)
    _, k_roll, k_upd = jax.random.split(jstate.key, 3)
    return jstate, jnew, mj, k_roll, k_upd


@pytest.mark.parametrize("branch", ["fused_t", "rowmajor"])
def test_make_train_step_bf16_matches_jax(branch):
    """One whole train step with fused_compute="bf16" on each branch, from
    the same state with JAX's draws injected: the fully fused step (B1 +
    B2) and the row-major one (the trainer's per-step auto-reset rollout,
    then B4 with the Adam step in the kernel); both build through
    `make_train_step`."""
    steps, b, hidden, minibatch = 2, 16, 32, 16
    env_cfg = ENV
    ppo_kw = dict(k_epochs=2, minibatch_size=minibatch, shuffle_block=8, fused_update=True,
                  fused_compute="bf16", fused_adam=branch == "rowmajor")
    # A 2-deep pool: the shape the rollout tests compile the pool's reset at.
    train_kw = dict(fused_rollout=branch == "fused_t", fused_pool=2)
    jstate, jnew, mj, k_roll, k_upd = _jax_step(ppo_kw, train_kw, steps, b, hidden)
    pcfg = tcfg.PPOConfig(**ppo_kw)
    ptrain = tcfg.TrainConfig(num_envs=b, rollout_steps=steps, network_size=hidden, **train_kw)
    model = ActorCritic.from_flax(jax.tree.map(np.asarray, jstate.params))
    opt = tppo.make_optimizer(model, pcfg)
    penv = port_env_config(env_cfg)
    assert tppo.train_branch(model, penv, pcfg, ptrain) == branch
    tppo.make_train_step(model, opt, penv, pcfg, ptrain)
    rows = steps * b
    if branch == "fused_t":
        k_noise, k_pool, _ = jax.random.split(k_roll, 3)
        noise = jax.random.normal(k_noise, (steps, 4, b))
        pool_keys = jax.random.split(k_pool, (ptrain.fused_pool, b))
        pool = jax.vmap(jrf.pack_env_state)(_reset_pool(pool_keys))
        perms = jax_perms(k_upd, pcfg.k_epochs, rows // 8, rows // minibatch)
        _, mt = tppo.train_step_from_inputs(
            model, opt, port_states(jstate.env_states), t(noise), t(pool), penv, pcfg,
            perms=torch.from_numpy(perms))
    else:
        jmodel = JActorCritic(hidden=hidden, action_std=STD)
        noise, fresh_x0, _ = jax_rollout_draws(jmodel, jstate.params, jstate.env_states, k_roll,
                                               env_cfg, steps, reset_pool=0)
        plan = tppo.update_plan(pcfg, rows, plain_adam=True)
        assert plan.branch == "fused_adam"
        perms = jax_perms(k_upd, pcfg.k_epochs, rows // plan.block, plan.n_mb,
                          plan.mb // plan.block)
        _, mt = tppo.rowmajor_step_from_inputs(
            model, opt, port_states(jstate.env_states), penv, pcfg, ptrain, noise=t(noise),
            fresh_x0=t(fresh_x0), perms=torch.from_numpy(perms))
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=2e-2)
    assert_params_close(model, jnew.params, atol=pcfg.lr * 5.0)
