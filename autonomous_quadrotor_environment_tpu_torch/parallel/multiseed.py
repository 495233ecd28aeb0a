"""Seed-parallel studies over ranks: the seed axis split over the ranks.

Counterpart of `parallel/multiseed.py` in the JAX package. A stacked study
(`agents.multiseed`) trains S seeds as one batched program on one card;
here the S seeds are split over the ranks, S / world on each, and each rank
trains its seeds alone. Seeds never talk to each other, so unlike the
data-parallel trainer (`parallel.dp`) nothing crosses the ranks: no
collective, and a seed's run is the one it has on one card.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..agents.multiseed import make_multiseed_train_loop, multiseed_init
from ..config import EnvConfig, PPOConfig, TrainConfig
from .dp import DPMesh


def local_seeds(seeds: Sequence, mesh: DPMesh) -> list:
    """This rank's share of ``seeds``: len(seeds) must divide by the world."""
    if len(seeds) % mesh.size:
        raise ValueError(f"{len(seeds)} seeds do not shard evenly over {mesh.size} ranks")
    k = len(seeds) // mesh.size
    return list(seeds)[mesh.rank * k:(mesh.rank + 1) * k]


def multiseed_init_sharded(seeds: Sequence[int], env_cfg: EnvConfig, ppo_cfg: PPOConfig,
                           train_cfg: TrainConfig, mesh: DPMesh, obs_dim: int = 75,
                           lrs: Optional[Sequence[float]] = None):
    """`agents.multiseed.multiseed_init` of this rank's seeds (and their
    learning rates), on ``mesh.device``."""
    mine = local_seeds(seeds, mesh)
    my_lrs = None if lrs is None else local_seeds(lrs, mesh)
    return multiseed_init(mine, env_cfg, ppo_cfg, train_cfg, obs_dim, my_lrs, device=mesh.device)


def make_multiseed_parallel_train_loop(model, opt, env_cfg: EnvConfig, ppo_cfg: PPOConfig,
                                       train_cfg: TrainConfig, mesh: DPMesh, inner: int):
    """``inner`` stacked updates of this rank's seeds: the stacked loop
    itself, since no seed needs another rank (``mesh`` names the world the
    state was sharded over, as the JAX signature does)."""
    return make_multiseed_train_loop(model, opt, env_cfg, ppo_cfg, train_cfg, inner)
