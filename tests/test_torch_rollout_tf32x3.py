"""The rollout kernel's arithmetic (B1, `csrc/rollout_fused.cu`), emulated in
PyTorch on the CPU: `rollout_plain`'s closed loop with the actor's two
products X W1^T (K = 80, inputs 75-79 zero) and H1 W2^T in 3xTF32 (the
split and depth-8 sums of `tests/test_torch_tf32x3.py`), the means summed
in the kernel's order (each lane's FMA chain over its units, the four lanes
of a row, then the eight MMA warps), and the value formed after the loop
by the same products over every stored observation, summed over the
critic pass's four warp slots.

- It holds the f32 plain version at atol = rtol = 1e-4 over 32 steps (the
  card's gate) at both bounding boxes, resets and pool wrap-around
  included; single-pass TF32 is printed beside it.
- It holds the JAX package's `rollout_twin` at the tolerances of
  `tests/test_torch_rollout_fused.py`.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.config import EnvConfig as JEnvConfig
from autonomous_quadrotor_environment_tpu.envs import hover as jhover
from autonomous_quadrotor_environment_tpu.ops import rollout_fused as jrf
from autonomous_quadrotor_environment_tpu_torch.ops import rollout_fused as trf
from test_torch_tf32x3 import mm1, mm3, mm32
from torch_parity import n, one_torch_thread, port_env_config, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, P, STD = 16, 2, 0.1
OBS, K1, H = trf.OBS, 80, 128  # the trainer's width, whose warp layout this mirrors


def _lane_units(slots: int, width: int, n_tiles: int) -> list:
    """The hidden units each (warp slot, lane t) sums, in its order: slot s
    owns units width * s.., lane t the pairs 8 nt + 2 t of each n8 tile."""
    return [[[width * s + 8 * nt + 2 * lane + p for nt in range(n_tiles) for p in range(2)]
             for lane in range(4)] for s in range(slots)]


ACTOR_UNITS = _lane_units(8, 16, 2)   # the loop: 8 MMA warps x 16 units
CRITIC_UNITS = _lane_units(4, 32, 4)  # the critic pass: 4 slots x 32 units


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _partials(h, w, units) -> list:
    """Per warp slot (n_out, n) sums of h (H, n) against w (n_out, H): each
    lane's FMA chain, then (v0 + v1) + (v2 + v3) as the two shuffles add."""
    out = []
    for slot in units:
        lanes = []
        for us in slot:
            s = torch.zeros(w.shape[0], h.shape[1])
            for u in us:
                s = _fma(h[u][None, :], w[:, u][:, None], s)
            lanes.append(s)
        out.append((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]))
    return out


def _hidden(x, w1, b1, w2, b2, mm):
    """Observations (75, n) -> h2 (H, n) through the kernel's two products:
    A = the inputs (n x 80, inputs 75-79 zero), B = W^T."""
    xa = torch.zeros(x.shape[1], K1)
    xa[:, :OBS] = x.T
    w1p = torch.zeros(H, K1)
    w1p[:, :OBS] = w1
    h1 = torch.tanh(mm(xa, w1p.T.contiguous()) + b1.reshape(1, -1))
    h2 = torch.tanh(mm(h1, w2.T.contiguous()) + b2.reshape(1, -1))
    return h2.T


def emulated_rollout(s0, noise, pool, wT, C, action_std, mm):
    """`rollout_plain` with the kernel's arithmetic; returns (s_final, obs
    (T, 75, B), misc (T, 16, B)) like it."""
    w1, b1, w2, b2, w3, b3, v1, c1, v2, c2, v3, c3 = wT
    lp_const = math.log(action_std) + 0.5 * math.log(2.0 * math.pi)
    s = s0
    obs_t, misc_t = [], []
    for eps in noise:
        obs = s[trf._HIST:trf._HIST + OBS]
        parts = _partials(_hidden(obs, w1, b1, w2, b2, mm), w3, ACTOR_UNITS)
        m = parts[0]
        for p in parts[1:]:
            m = m + p
        action = torch.tanh(m + b3) + action_std * eps
        logprob = -0.5 * eps * eps - lp_const
        s_next, reward, done, solved = trf.step_math(s, action, C)
        fresh = trf._pool_select(pool, s_next[trf._SLOT:trf._SLOT + 1], pool.shape[0])
        s = trf._merge_reset(s_next, fresh, done)
        obs_t.append(obs)
        misc_t.append(torch.cat([action, logprob, torch.zeros_like(reward), reward, done, solved,
                                 torch.zeros_like(action)], dim=0))
    obs_all, misc = torch.stack(obs_t), torch.stack(misc_t)
    steps, b = noise.shape[0], noise.shape[2]
    rows = obs_all.permute(1, 0, 2).reshape(OBS, steps * b)
    p = _partials(_hidden(rows, v1, c1, v2, c2, mm), v3, CRITIC_UNITS)
    misc[:, 8] = (((p[0] + p[1]) + p[2]) + p[3] + c3).reshape(steps, b)
    return s, obs_all, misc


def _inputs(bb_scale: float, steps: int, seed: int):
    """JAX-drawn start states, noise, a P-deep reset pool and a seeded
    model's transposed leaves, as numpy-backed CPU tensors and JAX arrays."""
    jc = dataclasses.replace(JEnvConfig(), bb_scale=bb_scale)
    key = jax.random.PRNGKey(seed)
    k_state, k_noise, k_pool = jax.random.split(key, 3)
    reset = jax.jit(jax.vmap(lambda k: jhover.reset(k, jc)))
    js = reset(jax.random.split(k_state, B))
    params = JActorCritic(hidden=H, action_std=STD).init(jax.random.PRNGKey(seed + 1),
                                                         jnp.zeros((1, OBS)))
    wT = jrf.transpose_leaves(params)
    noise = jax.random.normal(k_noise, (steps, 4, B))
    pool = jax.vmap(jrf.pack_env_state)(jax.jit(jax.vmap(jax.vmap(
        lambda k: jhover.reset(k, jc))))(jax.random.split(k_pool, (P, B))))
    j_in = (jrf.pack_env_state(js), noise, pool, wT)
    t_in = (t(j_in[0]), t(noise), t(pool), [t(w) for w in wT])
    return jc, j_in, t_in


def _max_err(got, want) -> float:
    return max((g - w).abs().max().item() for g, w in zip(got, want))


@pytest.mark.parametrize("bb_scale", [1.0, 0.15])
def test_kernel_arithmetic_holds_the_plain_version(bb_scale):
    """32 steps at 1e-4, as the card's kernel_vs_plain gate: the done
    histories equal, every output within atol = rtol = 1e-4."""
    jc, _, (s0, noise, pool, wT) = _inputs(bb_scale, steps=32, seed=3)
    C = trf._scalars(port_env_config(jc))
    want = trf.rollout_plain(s0, noise, pool, wT, C, STD)
    got = emulated_rollout(s0, noise, pool, wT, C, STD, mm3)
    single = emulated_rollout(s0, noise, pool, wT, C, STD, mm1)
    f32 = emulated_rollout(s0, noise, pool, wT, C, STD, mm32)
    same_done = torch.equal(single[2][:, 10], want[2][:, 10])
    print(f"\nbb_scale {bb_scale}: 3xTF32 max abs err {_max_err(got, want):.3e}, f32 in the "
          f"kernel's order {_max_err(f32, want):.3e}, single-pass TF32 "
          + (f"{_max_err(single, want):.3e}" if same_done else "(done histories differ)"))
    if bb_scale < 1.0:
        assert want[2][:, 10].sum() > 2 * B, "reset path not exercised"
        assert want[0][trf._SLOT].max() > P, "pool wrap-around not exercised"
    assert torch.equal(got[2][:, 10], want[2][:, 10])
    for name, g, w in zip(("s_final", "obs", "misc"), got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4, msg=name)
    torch.testing.assert_close(got[2][:, 8], want[2][:, 8], atol=1e-4, rtol=1e-4, msg="value")


@pytest.mark.parametrize("bb_scale,steps,tol", [(1.0, 8, 1e-6), (0.15, 32, 1e-5)])
def test_kernel_arithmetic_matches_jax_twin(bb_scale, steps, tol):
    """Against `rollout_twin` at `tests/test_torch_rollout_fused.py`'s
    tolerances: ``tol`` for the observations and the policy outputs, 1e-5
    for the reward and the final state (Euler-rate rows are angle
    differences times 1/dt)."""
    jc, (s0_j, noise_j, pool_j, wT_j), (s0, noise, pool, wT) = _inputs(bb_scale, steps, seed=5)
    jC = jrf._scalars(jc)
    s_j, outs_j = jax.jit(lambda *a: jrf.rollout_twin(*a, C=jC, action_std=STD))(
        s0_j, noise_j, pool_j, wT_j)
    s_t, obs_t, misc_t = emulated_rollout(s0, noise, pool, wT, trf._scalars(port_env_config(jc)),
                                          STD, mm3)
    obs_j, act_j, lp_j, val_j, rew_j, done_j, solved_j = outs_j
    np.testing.assert_allclose(n(obs_t), np.asarray(obs_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(n(misc_t[:, 0:4]), np.asarray(act_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(n(misc_t[:, 4:8]), np.asarray(lp_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(n(misc_t[:, 8:9]), np.asarray(val_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(n(misc_t[:, 9:10]), np.asarray(rew_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n(misc_t[:, 10:11]), np.asarray(done_j))
    np.testing.assert_array_equal(n(misc_t[:, 11:12]), np.asarray(solved_j))
    np.testing.assert_allclose(n(s_t), np.asarray(s_j), rtol=1e-5, atol=1e-5)


def test_post_loop_critic_is_the_plain_critic():
    """The critic pass alone: 3xTF32 products and the four slots' sums over
    seeded observations within 1e-5 of the plain f32 critic, and the lanes
    cover every hidden unit once."""
    for units in (ACTOR_UNITS, CRITIC_UNITS):
        flat = sorted(u for slot in units for lane in slot for u in lane)
        assert flat == list(range(H))
    rng = np.random.default_rng(9)
    obs = torch.from_numpy((rng.standard_normal((OBS, 512)) * 0.5).astype(np.float32))
    torch.manual_seed(9)
    v1, c1 = torch.randn(H, OBS) * 0.1, torch.randn(H, 1) * 0.1
    v2, c2 = torch.randn(H, H) * 0.1, torch.randn(H, 1) * 0.1
    v3, c3 = torch.randn(1, H) * 0.1, torch.randn(1, 1) * 0.1
    want = v3 @ torch.tanh(v2 @ torch.tanh(v1 @ obs + c1) + c2) + c3
    p = _partials(_hidden(obs, v1, c1, v2, c2, mm3), v3, CRITIC_UNITS)
    got = ((p[0] + p[1]) + p[2]) + p[3] + c3
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
