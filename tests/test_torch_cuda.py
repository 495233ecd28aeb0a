"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same CUDA tensors, the launch counts of train steps,
the wrappers' refusals, and the train step's refusal of shapes the kernels
do not take. They skip on a machine without a CUDA card. This file imports
nothing of JAX, so on the card (which has no JAX; tests/conftest.py imports
it) it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
from autonomous_quadrotor_environment_tpu_torch.agents import ppo
from autonomous_quadrotor_environment_tpu_torch.agents.ppo import fused_inputs
from autonomous_quadrotor_environment_tpu_torch.agents.gae import gae_advantages
from autonomous_quadrotor_environment_tpu_torch.config import (
    CameraConfig,
    EnvConfig,
    PPOConfig,
    RandomizationConfig,
    TrainConfig,
)
from autonomous_quadrotor_environment_tpu_torch.envs import hover
from autonomous_quadrotor_environment_tpu_torch.ops import ppo_fused as pr
from autonomous_quadrotor_environment_tpu_torch.ops import ppo_fused_t as pf
from autonomous_quadrotor_environment_tpu_torch.ops import render_kernel as rk
from autonomous_quadrotor_environment_tpu_torch.ops import rollout_fused as rf

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, b, steps, pool_size, bb_scale, hidden=128):
    cfg = EnvConfig(bb_scale=bb_scale)
    torch.manual_seed(0)
    model = ActorCritic(hidden=hidden).to(card)
    gen = torch.Generator(device=card).manual_seed(1)
    states = hover.reset(gen, cfg, n=b)
    return cfg, fused_inputs(model, states, gen, cfg, steps, pool_size)


@pytest.mark.parametrize(
    "b,steps,pool_size,bb_scale",
    [
        (64, 16, 2, 1.0),
        (48, 24, 3, 0.15),   # a ragged last tile; resets and pool wrap-around
        (1, 8, 1, 0.15),
    ],
)
def test_kernel_matches_plain(card, b, steps, pool_size, bb_scale):
    """atol = rtol = 1e-4 (as in chip_smoke.py's kernel_vs_plain phase):
    the kernel sums the products in another order than cuBLAS and fuses
    multiply-adds. Every env's done history must agree at these sizes."""
    cfg, (s0, noise, pool, wT) = _inputs(card, b, steps, pool_size, bb_scale)
    before = rf.fused_rollout.launches
    got = rf.fused_rollout(s0, noise, pool, wT, cfg, 0.1)
    torch.cuda.synchronize()
    assert rf.fused_rollout.launches == before + 1
    want = rf.rollout_plain(s0, noise, pool, wT, rf._scalars(cfg), 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got[2][:, 10], want[2][:, 10])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    assert not got[2][:, 12:16].any()
    if bb_scale < 1.0 and b > 1:
        assert want[2][:, 10].sum() > 2 * b


@pytest.mark.parametrize("b,steps", [(1, 32), (63, 32), (65, 32), (100, 32), (1000, 32), (100, 1)])
def test_kernel_at_the_tile_edges(card, b, steps):
    """B1 at sizes that cut its 64-env tile and its two 32-env groups (a
    lone env, 63, 65, 100, 1000; 63 and 65 take the critic pass's 4-byte
    copies) under the tight box with a 2-deep pool, so resets and pool
    wrap-around happen, and for a single step: held to the plain version as
    chip_smoke.py's kernel_vs_plain holds it (`compare`: every output, the
    value row among them, within atol = rtol = 1e-4 on the envs whose done
    histories agree), every env's done history equal up to B = 100, and a
    relaunch gives the same bits."""
    from chip_smoke import compare

    cfg, (s0, noise, pool, wT) = _inputs(card, b, steps, 2, 0.15)
    before = rf.fused_rollout.launches
    got = rf.fused_rollout(s0, noise, pool, wT, cfg, 0.1)
    again = rf.fused_rollout(s0, noise, pool, wT, cfg, 0.1)
    torch.cuda.synchronize()
    assert rf.fused_rollout.launches == before + 2
    want = rf.rollout_plain(s0, noise, pool, wT, rf._scalars(cfg), 0.1)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    res = compare(got, want, atol=1e-4, rtol=1e-4)
    if b <= 100:
        assert res["envs_compared"] == b
    if steps > 1 and b >= 63:
        assert want[2][:, 10].sum() > 2 * b, "reset path not exercised"
        assert want[0][rf._SLOT].max() > 2, "pool wrap-around not exercised"


@pytest.mark.parametrize("hidden,b", [(512, 65), (1152, 65), (1300, 65), (2048, 200),
                                      (1024, 8500)])
def test_wide_rollout_with_h1_in_shared_or_device_memory(card, hidden, b):
    """The wide rollout with h1 in shared memory (512 on 64-env tiles, 1152
    on 32-env tiles) and in device memory on 64-env tiles (1300 on 1408,
    2048, and 1024 at more envs than one wave of 32-env tiles holds), the
    last tile ragged, 16 steps under the tight box with a
    2-deep pool: held to the plain version as chip_smoke.py's
    kernel_options holds it (`compare` at atol = rtol = 1e-4, the
    Euler-rate rows within RATE_ATOL more), a relaunch bit-equal."""
    from chip_smoke import RATE_ATOL, compare

    cfg, (s0, noise, pool, wT) = _inputs(card, b, 16, 2, 0.15, hidden)
    before = rf.fused_rollout.launches
    got = rf.fused_rollout(s0, noise, pool, wT, cfg, 0.1)
    again = rf.fused_rollout(s0, noise, pool, wT, cfg, 0.1)
    torch.cuda.synchronize()
    assert rf.fused_rollout.launches == before + 2
    want = rf.rollout_plain(s0, noise, pool, wT, rf._scalars(cfg), 0.1)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    compare(got, want, atol=1e-4, rtol=1e-4, rate_atol=RATE_ATOL)


def test_kernel_refuses_what_it_does_not_take(card):
    cfg, (s0, noise, pool, wT) = _inputs(card, 32, 4, 2, 1.0)
    with pytest.raises(ValueError):
        rf.fused_rollout(s0.double(), noise, pool, wT, cfg, 0.1)
    with pytest.raises(ValueError):
        rf.fused_rollout(s0, noise[:, :, :16], pool, wT, cfg, 0.1)
    with pytest.raises(ValueError):
        rf.fused_rollout(s0, noise, pool, [w[:64] for w in wT], cfg, 0.1)
    with pytest.raises(ValueError):
        rf.fused_rollout(s0, noise.transpose(0, 1).contiguous().transpose(0, 1), pool, wT, cfg, 0.1)


def _grad_inputs(card, steps, b, seed=0):
    """Seeded update rows (T, 75, B) and (T, 8, B) with ratios on both sides
    of the clip band, and a seeded hidden-128 model."""
    g = torch.Generator(device=card).manual_seed(seed)
    obs = torch.randn(steps, 75, b, generator=g, device=card) * 0.3
    aux = torch.zeros(steps, 8, b, device=card)
    aux[:, 0:4] = torch.randn(steps, 4, b, generator=g, device=card) * 0.2
    aux[:, 4] = torch.randn(steps, b, generator=g, device=card) * 0.4 - 4.0
    aux[:, 5:7] = torch.randn(steps, 2, b, generator=g, device=card)
    torch.manual_seed(seed)
    model = ActorCritic(hidden=128).to(card)
    return model, obs, aux, g


def _rel_fro(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("steps,b,tile,n_blocks", [(8, 1024, 128, 24), (2, 64, 32, 4), (1, 32, 32, 1)])
def test_grad_kernel_matches_plain(card, steps, b, tile, n_blocks):
    """Loss and metrics within rtol 1e-4, each gradient leaf within a
    relative Frobenius error of 1e-4 (chip_smoke.py's grad_t_vs_plain
    tolerance: the kernel sums the rows in another order than cuBLAS).
    Two launches give the same bits: the reduction order is fixed."""
    model, obs, aux, g = _grad_inputs(card, steps, b)
    blocks = torch.randperm(steps * b // tile, generator=g, device=card)[:n_blocks].to(torch.int32)
    kw = dict(tile=tile, action_std=0.1, clip_eps=0.2, entropy_coef=0.006)
    before = pf.fused_ppo_grad_t.launches
    loss, met, grads = pf.fused_ppo_grad_t(model, obs, aux, blocks, **kw)
    loss2, _, grads2 = pf.fused_ppo_grad_t(model, obs, aux, blocks, **kw)
    torch.cuda.synchronize()
    assert pf.fused_ppo_grad_t.launches == before + 2
    lp, mp, gp = pf.ppo_grad_t_plain(model, obs, aux, blocks, **kw)
    torch.testing.assert_close(loss, lp, rtol=1e-4, atol=0)
    for k in mp:
        torch.testing.assert_close(met[k], mp[k], rtol=1e-4, atol=0, msg=k)
    for gk, gp_ in zip(grads, gp):
        assert gk.shape == gp_.shape
        assert _rel_fro(gk, gp_) <= 1e-4
    assert torch.equal(loss, loss2)
    assert all(torch.equal(x, y) for x, y in zip(grads, grads2))


def test_grad_kernel_refuses_what_it_does_not_take(card):
    model, obs, aux, _ = _grad_inputs(card, 2, 64)
    blocks = torch.arange(2, dtype=torch.int32, device=card)
    kw = dict(action_std=0.1, clip_eps=0.2, entropy_coef=0.006)
    before = pf.fused_ppo_grad_t.launches
    for bad in (
        lambda: pf.fused_ppo_grad_t(model, obs, aux, blocks, tile=24, **kw),   # does not divide B
        lambda: pf.fused_ppo_grad_t(model, obs, aux, blocks, tile=48, **kw),   # does not divide B
        lambda: pf.fused_ppo_grad_t(model, obs, aux, blocks.long(), tile=32, **kw),
        lambda: pf.fused_ppo_grad_t(model, obs.double(), aux, blocks, tile=32, **kw),
        lambda: pf.fused_ppo_grad_t(model, obs, aux[:, :7].contiguous(), blocks, tile=32, **kw),
        lambda: pf.fused_ppo_grad_t(model, obs.transpose(0, 1).contiguous().transpose(0, 1),
                                    aux, blocks, tile=32, **kw),
    ):
        with pytest.raises(ValueError):
            bad()
    assert pf.fused_ppo_grad_t.launches == before  # no launch, no fall back


def test_bench_shape_train_step_launches_both_kernels(card):
    """One train step at bench.py's shape (8192 x 256, K=10, quarter-batch
    minibatches, tile 1024): 1 rollout launch and K x 4 = 40 gradient
    launches, finite metrics, changed parameters."""
    env_cfg = EnvConfig(n_steps=1000)
    b, steps = 8192, 256
    pcfg = PPOConfig(k_epochs=10, minibatch_size=b * steps // 4, fused_update=True,
                     shuffle_block=1024)
    tcfg = TrainConfig(num_envs=b, rollout_steps=steps, network_size=128, fused_rollout=True)
    model, opt, state = ppo.ppo_init(0, env_cfg, pcfg, tcfg)
    step = ppo.make_train_step(model, opt, env_cfg, pcfg, tcfg)
    before = [p.detach().clone() for p in model.parameters()]
    rf.fused_rollout.launches = 0
    pf.fused_ppo_grad_t.launches = 0
    state, metrics = step(state)
    torch.cuda.synchronize()
    assert rf.fused_rollout.launches == 1
    assert pf.fused_ppo_grad_t.launches == 40
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))


# ---------------------------------------------------------------------------
# The row-major PPO kernels (B3 `fused_ppo_grad`, B4 `fused_ppo_grad_adam`)
# ---------------------------------------------------------------------------


def _row_inputs(card, n, seed=0, hidden=128):
    """Seeded row-major update rows (n, 75) and (n, 8), ratios on both sides
    of the clip band, and a seeded model."""
    g = torch.Generator(device=card).manual_seed(seed)
    obs = torch.randn(n, 75, generator=g, device=card) * 0.3
    aux = torch.zeros(n, 8, device=card)
    aux[:, 0:4] = torch.randn(n, 4, generator=g, device=card) * 0.2
    aux[:, 4] = torch.randn(n, generator=g, device=card) * 0.4 - 4.0
    aux[:, 5:7] = torch.randn(n, 2, generator=g, device=card)
    torch.manual_seed(seed)
    model = ActorCritic(hidden=hidden).to(card)
    return model, obs, aux, g


ROW_KW = dict(action_std=0.1, clip_eps=0.2, entropy_coef=0.006)


@pytest.mark.parametrize("n,tile,n_blocks", [(2048, 128, 12), (1200, 40, 13), (96, 8, 7), (512, 512, 1)])
def test_rows_grad_kernel_matches_plain(card, n, tile, n_blocks):
    """B3 against autograd on the gathered rows: loss and metrics within
    rtol 1e-4, each gradient leaf within a relative Frobenius error of 1e-4
    (chip_smoke.py's grad_vs_plain tolerance), the same bits on a second
    launch. Tiles 40 and 8 are not multiples of the kernel's 32-row chunk,
    so chunks span blocks and the last one is padded."""
    model, obs, aux, g = _row_inputs(card, n)
    blocks = torch.randperm(n // tile, generator=g, device=card)[:n_blocks].to(torch.int32)
    before = pr.fused_ppo_grad.launches
    loss, met, grads = pr.fused_ppo_grad(model, obs, aux, blocks, tile=tile, **ROW_KW)
    loss2, _, grads2 = pr.fused_ppo_grad(model, obs, aux, blocks, tile=tile, **ROW_KW)
    torch.cuda.synchronize()
    assert pr.fused_ppo_grad.launches == before + 2
    lp, mp, gp = pr.ppo_grad_plain(model, obs, aux, blocks, tile=tile, **ROW_KW)
    torch.testing.assert_close(loss, lp, rtol=1e-4, atol=0)
    for k in mp:
        torch.testing.assert_close(met[k], mp[k], rtol=1e-4, atol=0, msg=k)
    for gk, gp_ in zip(grads, gp):
        assert gk.shape == gp_.shape
        assert _rel_fro(gk, gp_) <= 1e-4
    assert torch.equal(loss, loss2)
    assert all(torch.equal(x, y) for x, y in zip(grads, grads2))


def _warm_adam(model, steps=3, seed=5):
    """An Adam over the model warmed by a few plain steps on seeded
    gradients, so that no moment is near zero."""
    opt = torch.optim.Adam(model.parameters(), lr=5e-4, eps=1e-8)
    g = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g, device=p.device) * 1e-2
        opt.step()
    for p in model.parameters():
        p.grad = None
    return opt


def test_rows_adam_kernel_matches_plain(card):
    """B4 from a warmed Adam state against the plain version on copies of
    the same state: loss within rtol 1e-4, new params, exp_avg and
    exp_avg_sq each within a relative Frobenius error of 1e-4 per leaf; the
    step count moves by one and `opt.step()` goes on from the kernel's
    state."""
    model, obs, aux, g = _row_inputs(card, 1200)
    blocks = torch.randperm(30, generator=g, device=card)[:13].to(torch.int32)
    opt = _warm_adam(model)
    params = [p for l in model.linears() for p in (l.weight, l.bias)]
    m0 = [opt.state[p]["exp_avg"].clone() for p in params]
    v0 = [opt.state[p]["exp_avg_sq"].clone() for p in params]
    leaves = [p.detach().clone() for p in params]
    want = pr.ppo_grad_adam_plain(leaves, m0, v0, 3, obs, aux, blocks, tile=40, lr=5e-4,
                                  b1=0.9, b2=0.999, **ROW_KW)
    before = pr.fused_ppo_grad_adam.launches
    loss, _ = pr.fused_ppo_grad_adam(model, opt, obs, aux, blocks, tile=40, **ROW_KW)
    torch.cuda.synchronize()
    assert pr.fused_ppo_grad_adam.launches == before + 1
    torch.testing.assert_close(loss, want[0], rtol=1e-4, atol=0)
    for i, p in enumerate(params):
        assert _rel_fro(p.detach(), want[2][i]) <= 1e-4
        assert _rel_fro(opt.state[p]["exp_avg"], want[3][i]) <= 1e-4
        assert _rel_fro(opt.state[p]["exp_avg_sq"], want[4][i]) <= 1e-4
        assert int(opt.state[p]["step"]) == 4
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    assert all(int(opt.state[p]["step"]) == 5 for p in params)


# The gradient kernels stage 64-row chunks; B2 loads each as two 32-env
# halves, which may lie in two row blocks, and pads a last chunk of 32 rows.


@pytest.mark.parametrize("steps,b,tile,n_blocks", [(2, 256, 32, 7), (2, 480, 96, 5), (4, 160, 160, 3)])
def test_grad_kernel_at_the_chunk_edges(card, steps, b, tile, n_blocks):
    """B2 at tiles that are odd multiples of 32 and odd block counts: chunks
    that span two blocks and a 32-row tail; within the same gates as
    `test_grad_kernel_matches_plain`, and the same bits on a second launch."""
    model, obs, aux, g = _grad_inputs(card, steps, b, seed=3)
    blocks = torch.randperm(steps * b // tile, generator=g, device=card)[:n_blocks].to(torch.int32)
    kw = dict(tile=tile, action_std=0.1, clip_eps=0.2, entropy_coef=0.006)
    loss, met, grads = pf.fused_ppo_grad_t(model, obs, aux, blocks, **kw)
    loss2, _, grads2 = pf.fused_ppo_grad_t(model, obs, aux, blocks, **kw)
    torch.cuda.synchronize()
    lp, mp, gp = pf.ppo_grad_t_plain(model, obs, aux, blocks, **kw)
    torch.testing.assert_close(loss, lp, rtol=1e-4, atol=0)
    for k in mp:
        torch.testing.assert_close(met[k], mp[k], rtol=1e-4, atol=0, msg=k)
    assert max(_rel_fro(gk, w) for gk, w in zip(grads, gp)) <= 1e-4
    assert torch.equal(loss, loss2)
    assert all(torch.equal(x, y) for x, y in zip(grads, grads2))


def test_grad_kernel_takes_a_batch_that_is_not_16_byte_aligned(card):
    """B2 copies 16-byte pieces of a feature row when obs and aux are 16-byte
    aligned, and 4-byte pieces otherwise: a contiguous batch that starts one
    float into its storage gives the same result as an aligned copy of it."""
    model, obs, aux, g = _grad_inputs(card, 2, 256, seed=5)
    blocks = torch.randperm(8, generator=g, device=card)[:5].to(torch.int32)
    kw = dict(tile=64, action_std=0.1, clip_eps=0.2, entropy_coef=0.006)
    shifted = []
    for x in (obs, aux):
        store = torch.empty(x.numel() + 1, device=card)
        store[1:] = x.reshape(-1)
        shifted.append(store[1:].view(x.shape))
    assert shifted[0].data_ptr() % 16 and shifted[1].data_ptr() % 16
    loss, _, grads = pf.fused_ppo_grad_t(model, obs, aux, blocks, **kw)
    loss_s, _, grads_s = pf.fused_ppo_grad_t(model, *shifted, blocks, **kw)
    torch.cuda.synchronize()
    assert torch.equal(loss, loss_s)
    assert all(torch.equal(x, y) for x, y in zip(grads, grads_s))


@pytest.mark.parametrize("n,tile,n_blocks", [(3000, 100, 7), (4800, 48, 45), (999, 37, 27)])
def test_rows_grad_kernel_at_the_chunk_edges(card, n, tile, n_blocks):
    """B3 at minibatches that are not multiples of 64 rows (700, 2160 and
    999): the last chunk is padded, chunks span blocks; the gates of
    `test_rows_grad_kernel_matches_plain` and the same bits on a relaunch."""
    model, obs, aux, g = _row_inputs(card, n, seed=4)
    blocks = torch.randperm(n // tile, generator=g, device=card)[:n_blocks].to(torch.int32)
    loss, met, grads = pr.fused_ppo_grad(model, obs, aux, blocks, tile=tile, **ROW_KW)
    loss2, _, grads2 = pr.fused_ppo_grad(model, obs, aux, blocks, tile=tile, **ROW_KW)
    torch.cuda.synchronize()
    lp, mp, gp = pr.ppo_grad_plain(model, obs, aux, blocks, tile=tile, **ROW_KW)
    torch.testing.assert_close(loss, lp, rtol=1e-4, atol=0)
    for k in mp:
        torch.testing.assert_close(met[k], mp[k], rtol=1e-4, atol=0, msg=k)
    assert max(_rel_fro(gk, w) for gk, w in zip(grads, gp)) <= 1e-4
    assert torch.equal(loss, loss2)
    assert all(torch.equal(x, y) for x, y in zip(grads, grads2))


def test_rows_adam_kernel_at_a_ragged_size(card):
    """B4 from a warmed Adam state on 27 blocks of 37 rows (999 rows, not a
    multiple of 64), against the plain version on copies of the state;
    a second launch from the same state gives the same bits."""
    model, obs, aux, g = _row_inputs(card, 1998, seed=6)
    blocks = torch.randperm(54, generator=g, device=card)[:27].to(torch.int32)
    opt = _warm_adam(model)
    params = [p for l in model.linears() for p in (l.weight, l.bias)]
    saved = [[x.detach().clone() for x in xs] for xs in (
        params, [opt.state[p]["exp_avg"] for p in params],
        [opt.state[p]["exp_avg_sq"] for p in params])]
    want = pr.ppo_grad_adam_plain([x.clone() for x in saved[0]], [x.clone() for x in saved[1]],
                                  [x.clone() for x in saved[2]], 3, obs, aux, blocks, tile=37,
                                  lr=5e-4, b1=0.9, b2=0.999, **ROW_KW)
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for i, p in enumerate(params):
                p.copy_(saved[0][i])
                opt.state[p]["exp_avg"].copy_(saved[1][i])
                opt.state[p]["exp_avg_sq"].copy_(saved[2][i])
                opt.state[p]["step"].fill_(3)
        loss, _ = pr.fused_ppo_grad_adam(model, opt, obs, aux, blocks, tile=37, **ROW_KW)
        torch.cuda.synchronize()
        runs.append((loss, [p.detach().clone() for p in params],
                     [opt.state[p]["exp_avg"].clone() for p in params],
                     [opt.state[p]["exp_avg_sq"].clone() for p in params]))
    torch.testing.assert_close(runs[0][0], want[0], rtol=1e-4, atol=0)
    for i in range(len(params)):
        assert _rel_fro(runs[0][1][i], want[2][i]) <= 1e-4
        assert _rel_fro(runs[0][2][i], want[3][i]) <= 1e-4
        assert _rel_fro(runs[0][3][i], want[4][i]) <= 1e-4
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(x, y) for a, b in zip(runs[0][1:], runs[1][1:]) for x, y in zip(a, b))


def test_rows_kernels_refuse_what_they_do_not_take(card):
    model, obs, aux, _ = _row_inputs(card, 256)
    blocks = torch.arange(2, dtype=torch.int32, device=card)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    before = (pr.fused_ppo_grad.launches, pr.fused_ppo_grad_adam.launches)
    for bad in (
        lambda: pr.fused_ppo_grad(model, obs, aux, blocks, tile=48, **ROW_KW),  # does not divide n
        lambda: pr.fused_ppo_grad(model, obs, aux, blocks.long(), tile=32, **ROW_KW),
        lambda: pr.fused_ppo_grad(model, obs.double(), aux, blocks, tile=32, **ROW_KW),
        lambda: pr.fused_ppo_grad(model, obs.t().contiguous().t(), aux, blocks, tile=32, **ROW_KW),
        lambda: pr.fused_ppo_grad(model, obs, aux[:, :7].contiguous(), blocks, tile=32, **ROW_KW),
        lambda: pr.fused_ppo_grad_adam(model, opt, obs, aux, blocks, tile=48, **ROW_KW),
        lambda: pr.fused_ppo_grad_adam(model, torch.optim.SGD(model.parameters(), lr=0.1), obs,
                                       aux, blocks, tile=32, **ROW_KW),
    ):
        with pytest.raises(ValueError):
            bad()
    assert (pr.fused_ppo_grad.launches, pr.fused_ppo_grad_adam.launches) == before


def test_make_train_step_refuses_shapes_the_card_kernels_do_not_take(card):
    """The configurations the card's kernels took to be refused (hidden 32,
    B2 tile 16, obs 60, bf16 products) now build, launch the kernels of their branch and
    step finitely, and so do widths that run zero-padded on an instantiation
    (20 on 32, 100 on 128, 200 on 256 for B1 and on the wide design for
    B2-B4), 300 on the wide designs (on 384: B1 fully fused, B3 and B4
    row-major), 1025 (on 1152, which was refused: B1 1 and B2 2 launches
    fully fused, B3 2 and B4 2 row-major), 1300 fully fused (B1's h1 in
    device memory) and obs too wide to stage (180,
    300); no width is refused; the autograd branch takes any width."""
    env_cfg = EnvConfig()
    small = TrainConfig(num_envs=64, rollout_steps=16, network_size=32)
    fused = dict(fused_update=True, k_epochs=2)
    # (PPOConfig, TrainConfig, launches of B1, B2, B3, B4 in one step)
    cases = [
        (PPOConfig(**fused), dataclasses.replace(small, fused_rollout=True), (1, 2, 0, 0)),
        (PPOConfig(k_epochs=2), dataclasses.replace(small, fused_rollout=True), (1, 0, 0, 0)),
        (PPOConfig(**fused), small, (0, 0, 2, 0)),
        (PPOConfig(fused_adam=True, **fused), small, (0, 0, 0, 2)),
        (PPOConfig(shuffle_block=16, **fused),                                  # B2 tile 16
         dataclasses.replace(small, network_size=128, fused_rollout=True), (1, 2, 0, 0)),
        (PPOConfig(fused_compute="bf16", **fused),                              # bf16 products
         dataclasses.replace(small, fused_rollout=True), (1, 2, 0, 0)),
        (PPOConfig(fused_compute="bf16", fused_adam=True, **fused), small, (0, 0, 0, 2)),
        (PPOConfig(**fused),                                                    # hidden 20
         dataclasses.replace(small, network_size=20, fused_rollout=True), (1, 2, 0, 0)),
        (PPOConfig(**fused),                                                    # hidden 300:
         dataclasses.replace(small, network_size=300, fused_rollout=True), (1, 2, 0, 0)),
        (PPOConfig(**fused), dataclasses.replace(small, network_size=300), (0, 0, 2, 0)),
        (PPOConfig(fused_adam=True, **fused),                                   # the wide designs
         dataclasses.replace(small, network_size=300), (0, 0, 0, 2)),
        (PPOConfig(**fused),                                                    # hidden 1025
         dataclasses.replace(small, network_size=1025, fused_rollout=True), (1, 2, 0, 0)),
        (PPOConfig(**fused),                                          # 1300: h1 in device memory
         dataclasses.replace(small, network_size=1300, fused_rollout=True), (1, 2, 0, 0)),
        (PPOConfig(**fused), dataclasses.replace(small, network_size=1025), (0, 0, 2, 0)),
        (PPOConfig(fused_adam=True, **fused),
         dataclasses.replace(small, network_size=1025), (0, 0, 0, 2)),
    ]
    wide = dataclasses.replace(small, network_size=128)
    short = dataclasses.replace(env_cfg, hist_t=4)  # 60-dim obs
    cases = [(env_cfg, p, t, w) for p, t, w in cases] + [
        (short, PPOConfig(**fused), wide, (0, 0, 2, 0)),                         # B3, obs 60
        (short, PPOConfig(fused_adam=True, **fused), wide, (0, 0, 0, 2)),        # B4, obs 60
        (dataclasses.replace(env_cfg, hist_t=12), PPOConfig(fused_adam=True, **fused),
         dataclasses.replace(small, network_size=200), (0, 0, 0, 2)),            # obs 180, 200
        (dataclasses.replace(env_cfg, hist_t=20), PPOConfig(**fused),
         dataclasses.replace(small, network_size=100), (0, 0, 2, 0)),            # obs 300, 100
    ]
    counters = (rf.fused_rollout, pf.fused_ppo_grad_t, pr.fused_ppo_grad, pr.fused_ppo_grad_adam)
    for env, pcfg, tcfg, want in cases:
        model, opt, state = ppo.ppo_init(0, env, pcfg, tcfg, obs_dim=env.hist_t * 15)
        step = ppo.make_train_step(model, opt, env, pcfg, tcfg)
        for c in counters:
            c.launches = 0
        state, metrics = step(state)
        torch.cuda.synchronize()
        assert tuple(c.launches for c in counters) == want, (pcfg, tcfg)
        assert all(torch.isfinite(v).all() for v in metrics.values())
    model, opt, state = ppo.ppo_init(0, env_cfg, PPOConfig(k_epochs=1), small)
    state, metrics = ppo.make_train_step(model, opt, env_cfg, PPOConfig(k_epochs=1), small)(state)
    assert all(torch.isfinite(v).all() for v in metrics.values())


@pytest.mark.parametrize("which", ["b3", "b4"])
def test_rowmajor_train_step_launches_its_kernels(card, which):
    """A row-major train step launches B3 K x n_mb times after the unfused
    rollout (fused_update), or B1 once and B4 K x n_mb times (fused_rollout
    and fused_adam), and nothing else."""
    env_cfg = EnvConfig()
    if which == "b3":
        pcfg = PPOConfig(k_epochs=3, fused_update=True)
        tcfg = TrainConfig(num_envs=256, rollout_steps=16)
        want = (0, 0, 3, 0)
    else:
        pcfg = PPOConfig(k_epochs=2, minibatch_size=1024, shuffle_block=256, fused_update=True,
                         fused_adam=True)
        tcfg = TrainConfig(num_envs=256, rollout_steps=16, fused_rollout=True)
        want = (1, 0, 0, 8)
    model, opt, state = ppo.ppo_init(0, env_cfg, pcfg, tcfg)
    step = ppo.make_train_step(model, opt, env_cfg, pcfg, tcfg)
    counters = (rf.fused_rollout, pf.fused_ppo_grad_t, pr.fused_ppo_grad, pr.fused_ppo_grad_adam)
    for c in counters:
        c.launches = 0
    before = [p.detach().clone() for p in model.parameters()]
    state, metrics = step(state)
    torch.cuda.synchronize()
    assert tuple(c.launches for c in counters) == want
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))


def _poses(card, b, seed=0):
    """Seeded render inputs: heights 0.01-7 m above the ground at z = -5,
    markers N(0, 0.8), brightness 0.5-1.2."""
    g = torch.Generator(device=card).manual_seed(seed)
    z = torch.rand(b, generator=g, device=card) * (7.0 - 0.01) + 0.01 - 5.0
    xy = torch.randn(b, 2, generator=g, device=card)
    quad = torch.cat([xy, z[:, None]], dim=1).contiguous()
    marker = torch.randn(b, 2, generator=g, device=card) * 0.8
    bright = torch.rand(b, generator=g, device=card) * 0.7 + 0.5
    return quad, marker, bright


@pytest.mark.parametrize("b", [1, 37, 300])
def test_render_kernel_matches_plain(card, b):
    """atol 1e-4 (chip_smoke.py's render_vs_plain tolerance): the image is
    continuous in the pose, so FMA contraction and the sin/cos libraries
    move pixels a little, most near the ground where the edges are
    sharpest; one relaunch gives the same bits."""
    quad, marker, bright = _poses(card, b)
    before = rk.render_nadir_batch.launches
    got = rk.render_nadir_batch(quad, marker, brightness=bright)
    again = rk.render_nadir_batch(quad, marker, brightness=bright)
    torch.cuda.synchronize()
    assert rk.render_nadir_batch.launches == before + 2
    want = rk.render_nadir_batch_plain(quad, marker, brightness=bright)
    assert got.shape == (b, 3, 84, 84) and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert torch.equal(got, again)
    # No brightness (the landing env's call), another ground height.
    torch.testing.assert_close(rk.render_nadir_batch(quad, marker, ground_z_env=-4.5),
                               rk.render_nadir_batch_plain(quad, marker, ground_z_env=-4.5),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("height,width,b", [(50, 60, 5), (43, 62, 3), (84, 84, 129),
                                            (480, 480, 14), (22, 4100, 2), (23, 4101, 2)])
def test_render_kernel_across_its_bands(card, height, width, b):
    """B5 where its 21-row bands do not divide the image (50 = 21 + 21 + 8,
    43 = 21 + 21 + 1 rows), at a width that is not a multiple of 4 (62:
    the scalar stores), at the landing camera with a batch past the eval's,
    at the mission camera (480 x 480, the missions' 14 episodes), and wider
    than one CTA's 2048-column span (4100 with float4 stores, 4101 with
    scalar ones, each in three spans): within atol 1e-4 of the plain
    version, the same bits on a relaunch."""
    cam = CameraConfig(width=width, height=height)
    quad, marker, bright = _poses(card, b, seed=height + width)
    got = rk.render_nadir_batch(quad, marker, cam=cam, brightness=bright)
    again = rk.render_nadir_batch(quad, marker, cam=cam, brightness=bright)
    torch.cuda.synchronize()
    want = rk.render_nadir_batch_plain(quad, marker, cam=cam, brightness=bright)
    assert got.shape == (b, 3, height, width)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert torch.equal(got, again)


def test_render_kernel_refuses_what_it_does_not_take(card):
    quad, marker, bright = _poses(card, 8)
    with pytest.raises(ValueError):
        rk.render_nadir_batch(quad.double(), marker)
    with pytest.raises(ValueError):
        rk.render_nadir_batch(quad, marker.double())
    with pytest.raises(ValueError):
        rk.render_nadir_batch(quad, marker, brightness=bright.cpu())
    with pytest.raises(ValueError):
        rk.render_nadir_batch(quad, marker[:4])
    with pytest.raises(ValueError):
        rk.render_nadir_batch(torch.zeros(8, 13, device=card)[:, 0:5:2], marker)


def test_landing_decisions_render_through_the_kernel(card):
    """A reset batch and each decision launch B5 once; the image is the
    plain renderer's within 1e-4."""
    from autonomous_quadrotor_environment_tpu_torch.fixtures import load_solved_controller
    from autonomous_quadrotor_environment_tpu_torch.landing import env as lenv

    cfgs = lenv.LandingConfigs.default(training=False)
    ctrl = load_solved_controller()
    gen = torch.Generator(device=card).manual_seed(0)
    rk.render_nadir_batch.launches = 0
    state, obs = lenv.landing_reset(gen, cfgs, ctrl, 16)
    state, out = lenv.landing_step(state, torch.zeros(16, 3, device=card), cfgs, ctrl, gen)
    torch.cuda.synchronize()
    assert rk.render_nadir_batch.launches == 2
    want = rk.render_nadir_batch_plain(state.env.x[:, 0:5:2], state.marker_world[:, 0:2])
    torch.testing.assert_close(out.obs.image, want, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# The robust trainer: B3 and B4 on batches of randomized physics and wind
# ---------------------------------------------------------------------------

ROBUST_ENV = EnvConfig(n_steps=1000, randomization=RandomizationConfig(enabled=True))


def _robust_rows(card, b=256, steps=16):
    """The rows of one robust `rollout_batch` after GAE, flattened row-major
    as `ppo_update` takes them, from a seeded model."""
    pcfg = PPOConfig(fused_update=True)
    tcfg = TrainConfig(num_envs=b, rollout_steps=steps)
    model, _, state = ppo.ppo_init(7, ROBUST_ENV, pcfg, tcfg)
    assert state.env_states.dom.mass_factor.abs().max() > 0
    _, roll, boot = ppo.rollout_batch(model, state.env_states, state.gen, ROBUST_ENV, steps)
    returns, advs = gae_advantages(roll.rewards, roll.values, roll.dones, boot, pcfg.gamma,
                                   pcfg.gae_lambda)
    n = b * steps
    obs = roll.obs.reshape(n, 75).contiguous()
    aux = pr.pack_aux(roll.actions.reshape(n, 4), roll.logprobs.reshape(n, 4),
                      returns.reshape(-1), advs.reshape(-1))
    return model, obs, aux


def test_rows_kernels_match_plain_on_a_randomized_batch(card):
    """B3 on every block and B4 from a warmed Adam state, on the rows of a
    robust rollout, against their plain versions at chip_smoke.py's gates:
    loss rtol 1e-4, leaves, params and moments within a relative Frobenius
    error of 1e-4; the same bits from a second B3 launch."""
    model, obs, aux = _robust_rows(card)
    tile = 128
    blocks = torch.arange(obs.shape[0] // tile, dtype=torch.int32, device=card)
    loss, _, grads = pr.fused_ppo_grad(model, obs, aux, blocks, tile=tile, **ROW_KW)
    loss2, _, grads2 = pr.fused_ppo_grad(model, obs, aux, blocks, tile=tile, **ROW_KW)
    lp, _, gp = pr.ppo_grad_plain(model, obs, aux, blocks, tile=tile, **ROW_KW)
    torch.testing.assert_close(loss, lp, rtol=1e-4, atol=0)
    assert all(_rel_fro(g, w) <= 1e-4 for g, w in zip(grads, gp))
    assert torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))

    opt = _warm_adam(model)
    params = [p for l in model.linears() for p in (l.weight, l.bias)]
    m0 = [opt.state[p]["exp_avg"].clone() for p in params]
    v0 = [opt.state[p]["exp_avg_sq"].clone() for p in params]
    leaves = [p.detach().clone() for p in params]
    want = pr.ppo_grad_adam_plain(leaves, m0, v0, 3, obs, aux, blocks, tile=tile, lr=5e-4,
                                  b1=0.9, b2=0.999, **ROW_KW)
    loss, _ = pr.fused_ppo_grad_adam(model, opt, obs, aux, blocks, tile=tile, **ROW_KW)
    torch.testing.assert_close(loss, want[0], rtol=1e-4, atol=0)
    for i, p in enumerate(params):
        assert _rel_fro(p.detach(), want[2][i]) <= 1e-4
        assert _rel_fro(opt.state[p]["exp_avg"], want[3][i]) <= 1e-4
        assert _rel_fro(opt.state[p]["exp_avg_sq"], want[4][i]) <= 1e-4


@pytest.mark.parametrize("which", ["b3", "b4"])
def test_robust_train_step_launches_its_kernels(card, which):
    """A robust train step runs on the row-major branch (the rollout kernel
    refuses randomization): K B3 launches with fused_update, K B4 with
    fused_adam too, and neither B1 nor B2."""
    flags = dict(fused_update=True) if which == "b3" else dict(fused_update=True,
                                                                fused_adam=True)
    pcfg = PPOConfig(k_epochs=3, **flags)
    tcfg = TrainConfig(num_envs=256, rollout_steps=16, fused_rollout=True)
    model, opt, state = ppo.ppo_init(0, ROBUST_ENV, pcfg, tcfg)
    assert ppo.train_branch(model, ROBUST_ENV, pcfg, tcfg) == "rowmajor"
    counters = (rf.fused_rollout, pf.fused_ppo_grad_t, pr.fused_ppo_grad, pr.fused_ppo_grad_adam)
    for c in counters:
        c.launches = 0
    before = [p.detach().clone() for p in model.parameters()]
    state, metrics = ppo.make_train_step(model, opt, ROBUST_ENV, pcfg, tcfg)(state)
    torch.cuda.synchronize()
    want = (0, 0, 3, 0) if which == "b3" else (0, 0, 0, 3)
    assert tuple(c.launches for c in counters) == want
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))


# ---------------------------------------------------------------------------
# The landing trainer: decision intervals as CUDA graphs, images from B5
# ---------------------------------------------------------------------------


def test_landing_train_step_through_graph_and_b5_matches_eager_plain(card, monkeypatch):
    """One float32 landing train step at 16 envs x 4 decisions (K=2, two
    minibatches an epoch) from the same model, draws and permutations:
    once with each decision interval replayed from its CUDA graph and the
    images from B5 (5 launches: the reset pool's batch and 4 decisions),
    once eagerly with the plain renderer. B5 differs from the
    plain renderer by up to 1e-4 on a few edge pixels, so: the metrics
    within rtol 1e-3, and each parameter's change over the 4 Adam steps
    within 2e-7 but for at most 1 in 1e3 elements (Adam's first step is
    lr * sign(g): a near-zero gradient may flip)."""
    import copy

    from autonomous_quadrotor_environment_tpu_torch.fixtures import load_solved_controller
    from autonomous_quadrotor_environment_tpu_torch.landing import env as lenv
    from autonomous_quadrotor_environment_tpu_torch.landing import ppo as lppo

    torch.backends.cudnn.allow_tf32 = False
    cfgs = lenv.LandingConfigs.default()
    cfg = dataclasses.replace(PPOConfig.landing_variant(), k_epochs=2, minibatch_size=32)
    ctrl = load_solved_controller()
    model, opt, state = lppo.landing_ppo_init(0, cfgs, cfg, 16, ctrl)
    gen = torch.Generator(device=card).manual_seed(1)
    draws = lppo.draw_rollout(gen, cfgs, 16, 4, 2)
    upd = lppo.draw_update(gen, lppo.update_plan(cfg, 64), 2)
    base = copy.deepcopy(model)
    runs = []
    for graphed in (True, False):
        m = copy.deepcopy(base)
        o = ppo.make_optimizer(m, cfg)
        st = dataclasses.replace(state, model=m, optimizer=o)
        if not graphed:
            monkeypatch.setattr(lenv, "interval", lenv._inner_interval)
            monkeypatch.setattr(lenv, "render_nadir_batch", rk.render_nadir_batch_plain)
        rk.render_nadir_batch.launches = 0
        _, met = lppo.make_landing_train_step(m, o, cfgs, cfg, ctrl, 4)(st, draws, upd)
        torch.cuda.synchronize()
        runs.append((met, [p.detach() - q.detach() for p, q in zip(m.parameters(),
                                                                     base.parameters())],
                     rk.render_nadir_batch.launches))
    (mg, dg, lg), (me, de, le) = runs
    assert lg == 5 and le == 0
    for k in mg:
        torch.testing.assert_close(mg[k], me[k], rtol=1e-3, atol=0, msg=k)
    flips = sum(int(((a - b).abs() > 2e-7).sum()) for a, b in zip(dg, de))
    assert flips <= 1e-3 * sum(a.numel() for a in dg), flips


# ---------------------------------------------------------------------------
# The controller's step loops as CUDA graphs (utils/graphs.py)
# ---------------------------------------------------------------------------


def _same(a, b) -> bool:
    from autonomous_quadrotor_environment_tpu_torch.utils import graphs

    la, lb = graphs.leaves(a), graphs.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("reset_pool", [0, 2])
def test_rollout_graph_is_bit_equal_to_eager(card, robust, reset_pool):
    """`rollout_batch` at 64 envs x 16 steps (bounding box 0.15, so episodes
    end and are replaced) replayed from its graph and run eagerly, from
    generators with the same seed: every output equal to the bit."""
    from autonomous_quadrotor_environment_tpu_torch.utils import graphs

    cfg = EnvConfig(bb_scale=0.15, randomization=RandomizationConfig(enabled=robust))
    tcfg = TrainConfig(num_envs=64, rollout_steps=16, network_size=32)
    model, _, state = ppo.ppo_init(3, cfg, PPOConfig(), tcfg, device=card)

    def roll():
        gen = torch.Generator(device=card).manual_seed(5)
        return ppo.rollout_batch(model, state.env_states, gen, cfg, 16, reset_pool)

    got, again = roll(), roll()
    with graphs.eager():
        want = roll()
    assert int(want[1].dones.sum()) > 0
    assert _same(got, want) and _same(again, want)


@pytest.mark.parametrize("robust", [False, True])
def test_fly_graph_is_bit_equal_to_eager(card, robust):
    """The forensic eval (`_fly`) of 32 episodes x 150 steps (three 64-step
    chunks, the last one short) through its graphs and eagerly, the gusts
    drawn from the same generator: every record equal to the bit."""
    from autonomous_quadrotor_environment_tpu_torch.utils import graphs

    cfg = EnvConfig(n_steps=145, randomization=RandomizationConfig(enabled=robust))
    torch.manual_seed(0)
    model = ActorCritic(hidden=32).to(card)
    fly = ppo.make_forensic_eval_fn(model, cfg, 32)
    got = fly(torch.Generator(device=card).manual_seed(2))
    with graphs.eager():
        want = fly(torch.Generator(device=card).manual_seed(2))
    assert _same(got, want)


RESET_ENVS = {
    # bb_scale 0.93: a config no other test of this process captures
    "default": EnvConfig(bb_scale=0.93),
    "robust": EnvConfig(bb_scale=0.93, randomization=RandomizationConfig(
        enabled=True, severity_sample=True)),
    "velocity": EnvConfig(bb_scale=0.93, vel_target_max=(1.0, 0.5, 0.8)),
}


@pytest.mark.parametrize("env", RESET_ENVS.keys())
def test_reset_replays_are_bit_equal_to_eager_and_counted(card, env):
    """`hover.reset_replayed` at a 4 x 8192 pool (32,768 envs), two
    successive replays from other draws, each equal to the bit to `reset`
    run eagerly on the same draws (no static buffer leaks from one call to
    the next); one replay counted a call; one capture per (config, n)."""
    from autonomous_quadrotor_environment_tpu_torch.utils import graphs

    cfg, n = RESET_ENVS[env], 32768
    key = ("hover.reset", cfg, torch.float32)
    captures, replays = graphs.CAPTURES.count, graphs.REPLAYS[key]
    gen = lambda seed: torch.Generator(device=card).manual_seed(seed)
    got = [hover.reset_replayed(gen(s), cfg, n) for s in (1, 2)]
    assert (graphs.CAPTURES.count, graphs.REPLAYS[key]) == (captures + 1, replays + 2)
    with graphs.eager():
        want = [hover.reset(gen(s), cfg, n) for s in (1, 2)]
    assert graphs.REPLAYS[key] == replays + 2
    assert not _same(want[0], want[1])
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    # another n is another graph; the first n's is replayed again
    assert _same(hover.reset_replayed(gen(3), cfg, 1024), hover.reset(gen(3), cfg, 1024))
    assert _same(hover.reset_replayed(gen(2), cfg, n), want[1])
    assert (graphs.CAPTURES.count, graphs.REPLAYS[key]) == (captures + 2, replays + 4)


@pytest.mark.parametrize("branch", ["fused_t", "rowmajor"])
def test_a_train_step_replays_its_fresh_episodes_reset_once(card, branch, monkeypatch):
    """A fully fused step (`fused_inputs`' pool) and a step at the trainer's
    defaults (`rollout_batch`'s fresh episodes) each reset through one
    replay of the reset graph: `reset` runs only at the capture, on drawn
    inputs."""
    from autonomous_quadrotor_environment_tpu_torch.utils import graphs

    env_cfg = EnvConfig(bb_scale=0.94)
    tcfg = TrainConfig(num_envs=256, rollout_steps=16, fused_rollout=branch == "fused_t")
    pcfg = (PPOConfig(k_epochs=1, minibatch_size=1024, shuffle_block=256, fused_update=True)
            if branch == "fused_t" else PPOConfig(k_epochs=1))
    model, opt, state = ppo.ppo_init(0, env_cfg, pcfg, tcfg)
    assert ppo.train_branch(model, env_cfg, pcfg, tcfg) == branch
    step = ppo.make_train_step(model, opt, env_cfg, pcfg, tcfg)
    key = ("hover.reset", env_cfg, torch.float32)
    before, captures, eager = graphs.REPLAYS[key], graphs.CAPTURES.count, []
    reset = hover.reset
    monkeypatch.setattr(hover, "reset",
                        lambda gen, *a, **kw: eager.append(gen) or reset(gen, *a, **kw))
    for i in range(3):
        state, metrics = step(state)
        assert graphs.REPLAYS[key] == before + i + 1
    torch.cuda.synchronize()
    assert all(torch.isfinite(v).all() for v in metrics.values())
    # the capture's two warm-up runs and the capture itself, in the first step
    assert eager == [None] * 3
    assert graphs.CAPTURES.count > captures


def test_a_replaced_parameter_makes_the_graph_raise(card):
    """A graph reads the model's weights in place: an in-place update is
    seen by the next replay, a parameter replaced by another tensor
    raises."""
    cfg = EnvConfig()
    torch.manual_seed(0)
    model = ActorCritic(hidden=32).to(card)
    fly = ppo.make_eval_fn(model, cfg, 8, max_steps=64)
    gen = lambda: torch.Generator(device=card).manual_seed(1)
    first = fly(gen())["eval_reward"]
    with torch.no_grad():
        model.actor[0].weight.mul_(0.5)
    assert fly(gen())["eval_reward"] != first
    model.actor[0].weight.data = model.actor[0].weight.data.clone()
    with pytest.raises(RuntimeError, match="replaced"):
        fly(gen())


def test_mission_chunk_replay_equals_its_eager_steps(card):
    """The RL and PID mission runners on the 14 target-table episodes for
    250 steps (two 100-step graphs and a 50-step one), the RL one on the
    fused sensor estimate, replayed and eagerly: logs equal to the bit."""
    from autonomous_quadrotor_environment_tpu_torch.apps import missions_eval as me
    from autonomous_quadrotor_environment_tpu_torch.config import SensorConfig
    from autonomous_quadrotor_environment_tpu_torch.fixtures import load_solved_controller
    from autonomous_quadrotor_environment_tpu_torch.utils import graphs

    steps = 250
    traj = me.episode_trajectories(0.01, card)
    draws = me.draw_sensors(0, traj.positions.shape[0], steps, card)
    rl = me.make_rl_mission_runner(EnvConfig(n_steps=steps, training=False),
                                   load_solved_controller(), SensorConfig(), True, steps)
    pid = me.make_pid_mission_runner(
        EnvConfig(n_steps=steps, direct_control=False, training=False), steps, card)
    got = (rl(traj, draws), pid(traj))
    with graphs.eager():
        want = (rl(traj, draws), pid(traj))
    for g, w in zip(got, want):
        assert (g == w).all()


def _vision_poses(e):
    """``e`` body-attached views over the board at 1.5-3 m, rolled and
    pitched by up to 6 degrees (no yaw: the detector orders the corners of
    an axis-aligned board), and one with the board out of view."""
    gen = torch.Generator().manual_seed(0)
    pos = torch.cat([torch.rand(e, 2, generator=gen) * 0.6 - 0.3,
                     torch.rand(e, 1, generator=gen) * 1.5 - 3.5], dim=1)
    pos[-1, 0] = 5.0
    tilt = (torch.rand(e, 2, generator=gen) - 0.5) * 0.1
    quat = torch.cat([torch.ones(e, 1), tilt, torch.zeros(e, 1)], dim=1)
    return pos, torch.zeros(e, 2), quat / quat.norm(dim=1, keepdim=True)


def test_vision_pose_batch_on_the_card_matches_the_cpu(card):
    """The missions camera's `vision_pose` on a batch of 8: ok flags equal
    to the CPU's, and where ok the position within 1e-3 m, the quaternion
    within 1e-3, the rms within 1e-2 px (chip_smoke.py's vision gates)."""
    from autonomous_quadrotor_environment_tpu_torch.config import MarkerConfig
    from autonomous_quadrotor_environment_tpu_torch.vision import vision_pose

    cam, marker = CameraConfig(width=480, height=480), MarkerConfig()
    args = _vision_poses(8)
    with torch.no_grad():
        cpu = vision_pose(*args[:2], cam, marker, quad_quat=args[2])
        got = vision_pose(*(x.to(card) for x in args[:2]), cam, marker,
                          quad_quat=args[2].to(card))
    assert torch.equal(got.ok.cpu(), cpu.ok) and bool(cpu.ok[:-1].all()) and not cpu.ok[-1]
    ok = cpu.ok
    assert (got.pos_env.cpu() - cpu.pos_env)[ok].abs().max() <= 1e-3
    assert (got.quat.cpu() - cpu.quat)[ok].abs().max() <= 1e-3
    assert (got.rms.cpu() - cpu.rms)[ok].abs().max() <= 1e-2


def test_vision_mission_graph_is_bit_equal_to_eager(card):
    """21 steps of the hybrid mission for 2 episodes (fixes due at steps 1,
    11 and 21; chunks of 100, so one graph keyed by phase 0) replayed from
    its CUDA graph and run eagerly from the same draws: bit-equal."""
    from autonomous_quadrotor_environment_tpu_torch.apps import missions_eval as me
    from autonomous_quadrotor_environment_tpu_torch.config import SensorConfig
    from autonomous_quadrotor_environment_tpu_torch.fixtures import SOLVED_CONTROLLER
    from autonomous_quadrotor_environment_tpu_torch.apps.robust_eval import load_policy
    from autonomous_quadrotor_environment_tpu_torch.missions import (
        stack_trajectories,
        target_parse,
    )
    from autonomous_quadrotor_environment_tpu_torch.utils import graphs

    steps = 21
    cfg = EnvConfig(n_steps=steps, direct_control=True, training=False)
    model = load_policy(SOLVED_CONTROLLER, 128, card)
    run = me.make_rl_mission_runner(cfg, model, SensorConfig(), True, steps, use_vision=True)
    traj = stack_trajectories([me._make_traj(target_parse(ep), cfg.dt) for ep in (0, 4)])
    draws = me.draw_sensors(0, 2, steps, card)
    graph = run(traj, draws)
    with graphs.eager():
        eager = run(traj, draws)
    assert (graph == eager).all()
    assert (graph[:, 1, 17] != 0).all()


@pytest.mark.parametrize("mode", [0, 2])
def test_live_mission_frames_replay_bit_equal_to_eager(card, mode):
    """8 frames of `live_mission`'s true-state and hybrid chunk steppers
    (chunks of 5 from `graphs.scan(start=)`; the hybrid one's graphs keyed
    by phases 0 and 5, fixes due at steps 1, 11, 21 and 31) replayed from
    their CUDA graphs and run eagerly from the same draws: bit-equal, and
    equal to the mission runner's rows."""
    from autonomous_quadrotor_environment_tpu_torch.apps import live_mission
    from autonomous_quadrotor_environment_tpu_torch.apps import missions_eval as me
    from autonomous_quadrotor_environment_tpu_torch.apps.robust_eval import load_policy
    from autonomous_quadrotor_environment_tpu_torch.config import SensorConfig
    from autonomous_quadrotor_environment_tpu_torch.fixtures import SOLVED_CONTROLLER
    from autonomous_quadrotor_environment_tpu_torch.missions import (
        stack_trajectories,
        target_parse,
    )
    from autonomous_quadrotor_environment_tpu_torch.utils import graphs

    chunk, frames = 5, 8
    cfg = EnvConfig(n_steps=me.MISSION_STEPS, direct_control=True, training=False)
    model = load_policy(SOLVED_CONTROLLER, 128, card)
    traj = stack_trajectories([me._make_traj(target_parse(1), cfg.dt)]).to(card)
    table = (traj.positions, traj.velocities)
    draws = me.draw_sensors(0, 1, chunk * frames, card)
    step = live_mission.make_steppers(cfg, model, SensorConfig(), chunk)[mode]
    init = me.make_mission_body(cfg, model, SensorConfig(), False)[1]

    def fly():
        carry, rows = init(1, draws.drift_u), []
        with torch.no_grad():
            for f in range(frames):
                noise = graphs.tree_map(lambda a: a[f * chunk:(f + 1) * chunk], draws.noise)
                carry, row = step(carry, f * chunk, noise, table)
                rows.append(row[0])
        return torch.stack(rows)

    graph = fly()
    with graphs.eager():
        eager = fly()
    assert (graph == eager).all()
    want = me.make_rl_mission_runner(cfg, model, SensorConfig(), mode > 0, chunk * frames,
                                     use_vision=mode == 2)(traj, draws if mode else None)
    assert (graph.cpu().numpy() == want[0, chunk - 1::chunk]).all()


@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_dp_steps_on_the_card(card, backend, world):
    """Data-parallel train steps on the card (`parallel.dp`): one rank per
    card over NCCL, or 2 ranks on one card over gloo. Per rank and step the
    launches of the counted kernels (B1, B2, B3, B4, B5): 1 B1 and 4 B2
    fully fused; 2 B3 and no B4 row-major with fused_adam set, since the
    Adam step in B4 would not see the reduced gradient; parameters equal on
    every rank after every step."""
    from autonomous_quadrotor_environment_tpu_torch.ops import _build
    from autonomous_quadrotor_environment_tpu_torch.parallel import launch

    import torch_dp_ranks

    if backend == "nccl" and torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} cards")
    for name, defines in (("rollout_fused", rf.library(128)),
                          ("ppo_fused_t", pf.library(128, 75, "f32")),
                          ("ppo_fused", pf.library(128, 75, "f32"))):
        _build.build(name, defines)  # once here, not in every rank at once
    devices = [f"cuda:{r}" for r in range(world)] if backend == "nccl" else ["cuda:0"] * world
    ranks = launch.spawn(torch_dp_ranks.card_dp_rank, devices, backend, timeout=300,
                         deadline=600)
    for r in ranks:
        assert [s["launches"] for s in r["fused"]] == [[1, 4, 0, 0, 0]] * 2
        assert [s["launches"] for s in r["rowmajor"]] == [[0, 0, 2, 0, 0]] * 2
        assert all(s["same"] for path in r.values() for s in path)
        assert all(s["loss"] == s["loss"] for path in r.values() for s in path)


def test_stacked_rollout_and_eval_graphs_match_eager(card):
    """The stacked study's rollout (3 seeds x 64 envs x 16 steps, one graph
    replay) and eval (3 x 32 episodes) replayed from their CUDA graphs and
    run eagerly from the same draws: bit-equal; no counted kernel
    launched."""
    from autonomous_quadrotor_environment_tpu_torch.agents import multiseed
    from autonomous_quadrotor_environment_tpu_torch.utils import graphs

    env_cfg, pcfg = EnvConfig(), PPOConfig(k_epochs=2)
    tcfg = TrainConfig(num_envs=64, rollout_steps=16)
    model, _, state = multiseed.multiseed_init([0, 1, 2], env_cfg, pcfg, tcfg, device=card)
    draws = [multiseed.draw_step(g, env_cfg, pcfg, 64, 16, 0) for g in state.gens]
    before = [k.launches for k in graphs._counted()]
    got = multiseed.stacked_rollout(model, state.env_states, draws, env_cfg, 16)
    ev = multiseed.make_multiseed_eval_fn(model, env_cfg, 32)
    gens = lambda: [torch.Generator(device=card).manual_seed(s) for s in (5, 6, 7)]
    got_eval = ev(gens())
    with graphs.eager():
        want = multiseed.stacked_rollout(model, state.env_states, draws, env_cfg, 16)
        want_eval = ev(gens())
    torch.cuda.synchronize()
    assert [k.launches for k in graphs._counted()] == before
    for a, b in zip(graphs.leaves((got, got_eval)), graphs.leaves((want, want_eval))):
        assert torch.equal(a, b)
