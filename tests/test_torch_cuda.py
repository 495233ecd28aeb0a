"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same CUDA tensors, the launch counts of a train step,
and the wrappers' refusals. They skip on a machine without a CUDA card. This file imports nothing of JAX, so on the card (which has no
JAX; tests/conftest.py imports it) it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
from autonomous_quadrotor_environment_tpu_torch.agents import ppo
from autonomous_quadrotor_environment_tpu_torch.agents.ppo import fused_inputs
from autonomous_quadrotor_environment_tpu_torch.config import EnvConfig, PPOConfig, TrainConfig
from autonomous_quadrotor_environment_tpu_torch.envs import hover
from autonomous_quadrotor_environment_tpu_torch.ops import ppo_fused_t as pf
from autonomous_quadrotor_environment_tpu_torch.ops import rollout_fused as rf

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, b, steps, pool_size, bb_scale):
    cfg = EnvConfig(bb_scale=bb_scale)
    torch.manual_seed(0)
    model = ActorCritic(hidden=128).to(card)
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
        lambda: pf.fused_ppo_grad_t(model, obs, aux, blocks, tile=16, **kw),   # not a multiple of 32
        lambda: pf.fused_ppo_grad_t(model, obs, aux, blocks, tile=48, **kw),   # does not divide B
        lambda: pf.fused_ppo_grad_t(ActorCritic(hidden=32).to(card), obs, aux, blocks, tile=32, **kw),
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
