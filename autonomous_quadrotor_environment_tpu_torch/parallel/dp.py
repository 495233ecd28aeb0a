"""Data-parallel PPO over the ranks of a `torch.distributed` group.

Counterpart of `parallel/dp.py` in the JAX package, whose step is a
`shard_map` over a device mesh. Here every function is called on every rank
of an initialised process group (`parallel.launch.spawn` starts the ranks
and hands each a `DPMesh`):

* the parameters and the optimizer are replicated: every rank builds the
  same model from the same seed and applies the same update, the mean over
  the ranks of each minibatch's gradients;
* the env batch is split over the ranks: ``num_envs`` is the global batch
  and must divide by the world size, each rank rolling out its slice;
* each rank draws from a generator of its own (JAX: one key per device).

A minibatch's gradients cross the ranks as one flat buffer in one
`all_reduce` (a sum, then a division by the world size: JAX's pmean), a
step's metrics as one vector. No collective sits inside a CUDA graph: the
rollout's graph (`utils.graphs`) holds none, and the reduces run between
the update's launches. A world of one rank computes what the serial step
computes, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..agents.ppo import make_train_loop, make_train_step, ppo_init, stream
from ..config import EnvConfig, PPOConfig, TrainConfig
from ..envs import hover
from ..utils import graphs

_RANK = 3  # stream tag of a rank's own generator (train_control's tags are 1 and 2)


@dataclasses.dataclass(frozen=True)
class DPMesh:
    """This rank's place in the data-parallel group: its rank, the world
    size, the device its tensors live on, and the process group (None: the
    default one)."""

    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    def mean(self, tensors: list) -> list:
        """The mean over the ranks of each tensor, element by element: one
        `all_reduce` of one flat buffer. Every rank gets the same values."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        flat.div_(self.size)
        return [x.view_as(t) for x, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def mean_metrics(self, metrics: dict) -> dict:
        """The mean over the ranks of a dict of 0-d tensors, as one vector."""
        keys = list(metrics)
        vec = self.mean([torch.stack([metrics[k].float() for k in keys])])[0]
        return dict(zip(keys, vec.unbind()))

    def broadcast_flag(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank: a decision to stop or to change
        stage, which every rank must take at the same update."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.broadcast(t, src=0, group=self.group)
        return bool(t.item())

    def same_everywhere(self, tensors: list) -> bool:
        """Whether every rank holds these tensors bit for bit (an
        element-wise max and min over the ranks agree)."""
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        hi, lo = flat.clone(), flat.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=self.group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=self.group)
        return bool(torch.equal(hi, lo))


def make_dp_mesh(device, group: Optional[dist.ProcessGroup] = None) -> DPMesh:
    """This rank's `DPMesh` in the initialised process ``group`` (the default
    one when None), its tensors on ``device``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise one first (parallel.launch.spawn does)")
    return DPMesh(rank=dist.get_rank(group), size=dist.get_world_size(group),
                  device=torch.device(device), group=group)


def local_envs(num_envs: int, mesh: DPMesh) -> int:
    """The envs one rank rolls out of the global ``num_envs``."""
    if num_envs % mesh.size:
        raise ValueError(f"num_envs={num_envs} not divisible by dp={mesh.size}")
    return num_envs // mesh.size


def shard(tree, num_envs: int, mesh: DPMesh):
    """This rank's slice of a batched tree (env states, observations)."""
    n = local_envs(num_envs, mesh)
    return graphs.tree_map(lambda x: x[mesh.rank * n:(mesh.rank + 1) * n], tree)


def rank_generator(gen: torch.Generator, mesh: DPMesh, seed: int, *tags: int) -> torch.Generator:
    """Rank 0 goes on drawing from ``gen``; rank r > 0 from a generator of
    its own, the stream ``(seed, *tags, r)``. So a world of one draws what
    the serial trainer draws."""
    if mesh.rank == 0:
        return gen
    return torch.Generator(device=gen.device).manual_seed(
        stream(seed, _RANK, *tags, mesh.rank))


def reset_sharded(gen: torch.Generator, env_cfg: EnvConfig, num_envs: int, mesh: DPMesh,
                  seed: int, *tags: int):
    """`hover.reset(gen, env_cfg, n=num_envs)` on every rank, which keeps
    its slice of the envs, and the rank's generator (`rank_generator`)."""
    states = hover.reset(gen, env_cfg, n=num_envs)
    return shard(states, num_envs, mesh), rank_generator(gen, mesh, seed, *tags)


def ppo_init_sharded(seed: int, env_cfg: EnvConfig, ppo_cfg: PPOConfig, train_cfg: TrainConfig,
                     mesh: DPMesh, obs_dim: int = 75):
    """`agents.ppo.ppo_init` on every rank (the same model and optimizer
    everywhere), the global batch of ``train_cfg.num_envs`` envs split over
    the ranks, each rank with its own generator; on ``mesh.device``."""
    local_envs(train_cfg.num_envs, mesh)
    model, opt, state = ppo_init(seed, env_cfg, ppo_cfg, train_cfg, obs_dim, device=mesh.device)
    state = dataclasses.replace(state, env_states=shard(state.env_states, train_cfg.num_envs, mesh),
                                gen=rank_generator(state.gen, mesh, seed))
    return model, opt, state


def make_parallel_train_step(model, opt, env_cfg: EnvConfig, ppo_cfg: PPOConfig,
                             train_cfg: TrainConfig, mesh: DPMesh):
    """`agents.ppo.make_train_step` on this rank's slice of the envs, each
    minibatch's gradients and the step's metrics averaged over the ranks,
    the kernels' gates read at the per-rank batch (JAX dp.py:126-141)."""
    return make_train_step(model, opt, env_cfg, ppo_cfg, train_cfg, grad_reduce=mesh.mean,
                           metric_reduce=mesh.mean_metrics,
                           local_envs=local_envs(train_cfg.num_envs, mesh))


def make_parallel_train_loop(model, opt, env_cfg: EnvConfig, ppo_cfg: PPOConfig,
                             train_cfg: TrainConfig, mesh: DPMesh, inner: int):
    """``inner`` sequential `make_parallel_train_step` steps, the metrics
    stacked to (inner,)."""
    return make_train_loop(model, opt, env_cfg, ppo_cfg, train_cfg, inner,
                           grad_reduce=mesh.mean, metric_reduce=mesh.mean_metrics,
                           local_envs=local_envs(train_cfg.num_envs, mesh))
