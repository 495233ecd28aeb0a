"""Data-parallel training over ranks of a `torch.distributed` group, and
seed-parallel studies.

Counterpart of `parallel/` in the JAX package, which replaced the
reference's rollout-worker pool (ppo.py:44, :359-369) and its mother/child
file protocol (visual_landing/rl_worker.py:267-342) by a `shard_map` over a
device mesh. Here each rank is a process (`launch.spawn`), one card each
over NCCL (gloo on the CPU): parameters replicated, env batches split,
gradients averaged by one `all_reduce` per minibatch.
"""

from .dp import (
    DPMesh,
    make_dp_mesh,
    make_parallel_train_loop,
    make_parallel_train_step,
    ppo_init_sharded,
)
from .dp_landing import (
    landing_ppo_init_sharded,
    make_landing_parallel_train_loop,
    make_landing_parallel_train_step,
)
from .launch import RankError, rank_devices, spawn
from .multiseed import make_multiseed_parallel_train_loop, multiseed_init_sharded

__all__ = [
    "DPMesh",
    "RankError",
    "landing_ppo_init_sharded",
    "make_dp_mesh",
    "make_landing_parallel_train_loop",
    "make_landing_parallel_train_step",
    "make_multiseed_parallel_train_loop",
    "make_parallel_train_loop",
    "make_parallel_train_step",
    "multiseed_init_sharded",
    "ppo_init_sharded",
    "rank_devices",
    "spawn",
]
