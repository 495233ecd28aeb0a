"""Rank bodies for the port's data-parallel tests. A spawned rank imports
its function from this module by name, so it imports torch and the port
only: no JAX (`tests/conftest.py` imports JAX, and a rank must not)."""

import os

import torch

from autonomous_quadrotor_environment_tpu_torch.agents import ppo
from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic, to_flax
from autonomous_quadrotor_environment_tpu_torch.config import PPOConfig


def _grads(params, rows) -> list:
    model = ActorCritic.from_flax(params)
    with torch.enable_grad():
        loss, _ = ppo.ppo_loss(model, *(torch.tensor(x) for x in rows), PPOConfig())
        return list(torch.autograd.grad(loss, list(model.parameters())))


def grads_of_rows(params, rows) -> list:
    """The `ppo_loss` gradients of ``rows`` (obs, actions, old logprobs,
    returns, advantages) for the flax ``params``, in
    `ActorCritic.parameters` order, as numpy."""
    return [g.numpy() for g in _grads(params, rows)]


def grads_rank(mesh, params, shards) -> list:
    """The mean over the ranks of each rank's `grads_of_rows` of its rows
    ``shards[rank]``."""
    return [g.numpy() for g in mesh.mean(_grads(params, shards[mesh.rank]))]


def step_rank(mesh, params, states, draws, env_cfg, ppo_cfg, train_cfg) -> dict:
    """One row-major dp train step of this rank from its env states and its
    draws (``states[rank]``, ``draws[rank]``: `rowmajor_step_from_inputs`'s
    keywords), as `parallel.dp.make_parallel_train_step` takes it: the
    gradients and metrics averaged over the ranks. Returns the updated
    parameters (flax tree), the metrics and whether every rank holds the
    same parameters."""
    model = ActorCritic.from_flax(params)
    opt = ppo.make_optimizer(model, ppo_cfg)
    _, metrics = ppo.rowmajor_step_from_inputs(model, opt, states[mesh.rank], env_cfg, ppo_cfg,
                                               train_cfg, grad_reduce=mesh.mean,
                                               **draws[mesh.rank])
    metrics = mesh.mean_metrics(metrics)
    return {"params": to_flax(model), "metrics": {k: float(v) for k, v in metrics.items()},
            "same": mesh.same_everywhere(list(model.parameters()))}


def landing_rank(mesh, seed, num_envs, steps, draws, ppo_cfg) -> dict:
    """One dp landing train step (`parallel.dp_landing`) of this rank's
    slice of ``num_envs`` episodes from its rollout draws ``draws[rank]``:
    the first minibatch's averaged gradients, the averaged metrics, and
    whether every rank holds the same parameters afterwards."""
    from autonomous_quadrotor_environment_tpu_torch.fixtures import load_solved_controller
    from autonomous_quadrotor_environment_tpu_torch.landing.env import LandingConfigs
    from autonomous_quadrotor_environment_tpu_torch.parallel import dp_landing

    ctrl = load_solved_controller(device="cpu")
    cfgs = LandingConfigs.default(training=True)
    model, opt, state = dp_landing.landing_ppo_init_sharded(seed, cfgs, ppo_cfg, num_envs, ctrl,
                                                            mesh)
    reduced = []

    class Capturing(type(mesh)):
        def mean(self, tensors):
            out = super().mean(tensors)
            reduced.append([g.clone().numpy() for g in out])
            return out

    step = dp_landing.make_landing_parallel_train_step(
        model, opt, cfgs, ppo_cfg, ctrl, steps,
        Capturing(mesh.rank, mesh.size, mesh.device, mesh.group))
    _, metrics = step(state, rollout_draws=draws[mesh.rank])
    return {"grads": reduced[0], "metrics": {k: float(v) for k, v in metrics.items()},
            "same": mesh.same_everywhere(list(model.parameters()))}


def failing_rank(mesh, how: str) -> None:
    """Rank 1 fails (``how``: "raises" or "dies" without a word) while rank
    0 waits for it in an all_reduce."""
    import torch.distributed as dist

    if mesh.rank == 1:
        if how == "raises":
            raise RuntimeError("rank 1 fails on purpose")
        os._exit(3)
    dist.all_reduce(torch.ones(1))



def card_dp_rank(mesh) -> dict:
    """Two dp train steps on the card per path, each rank's launches of
    each step: fully fused (1 B1 and K x 2 B2 launches) and row-major with
    fused_update and fused_adam (K B3 launches, B4 none under the reduce);
    and whether every rank holds the same parameters after each step."""
    from autonomous_quadrotor_environment_tpu_torch.config import EnvConfig, TrainConfig
    from autonomous_quadrotor_environment_tpu_torch.parallel import dp
    from autonomous_quadrotor_environment_tpu_torch.utils.graphs import _counted

    torch.backends.cuda.matmul.allow_tf32 = False
    env_cfg, b, t = EnvConfig(), 128, 16
    out = {}
    for path, pcfg, tcfg in [
        ("fused", PPOConfig(k_epochs=2, minibatch_size=b // mesh.size * t // 2,
                            fused_update=True, shuffle_block=32),
         TrainConfig(num_envs=b, rollout_steps=t, fused_rollout=True)),
        ("rowmajor", PPOConfig(k_epochs=2, fused_update=True, fused_adam=True),
         TrainConfig(num_envs=b, rollout_steps=t)),
    ]:
        model, opt, state = dp.ppo_init_sharded(0, env_cfg, pcfg, tcfg, mesh)
        step = dp.make_parallel_train_step(model, opt, env_cfg, pcfg, tcfg, mesh)
        rows = []
        for _ in range(2):
            before = [k.launches for k in _counted()]
            state, metrics = step(state)
            torch.cuda.synchronize()
            rows.append({"launches": [k.launches - n for k, n in zip(_counted(), before)],
                         "same": mesh.same_everywhere(list(model.parameters())),
                         "loss": float(metrics["loss"])})
        out[path] = rows
    return out
