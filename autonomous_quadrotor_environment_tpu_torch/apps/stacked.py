"""Stacked-study runner: N training cells as one batched program.

Counterpart of `apps/stacked.py` in the JAX package, the engine of
`seed_study --stacked`, `lr_sweep --stacked` and `size_sweep --stacked`.
The reference ran every cell as its own cluster job (slurm_output/,
training_log/lr_test/); here the cells are the seed axis of
`agents.multiseed` (a cell's learning rate rides the stacked optimizer's
state), and each keeps its own CSV and JSONL in the reference's 16-column
schema (`utils.metrics.TRAIN_LOG_HEADER`), so the analyzers read them as
they read a serial run's.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from datetime import datetime
from typing import Optional

import torch

from ..agents.multiseed import (
    make_multiseed_eval_fn,
    make_multiseed_train_loop,
    multiseed_init,
    seed_slice,
)
from ..agents.networks import to_flax
from ..agents.ppo import stream
from ..config import EnvConfig, PPOConfig, TrainConfig
from ..device import resolve_device
from ..utils import TRAIN_LOG_HEADER, CSVLogger, JSONLLogger, save_params
from .train_control import _EVAL


@dataclass(frozen=True)
class StackedCell:
    """One training run in the stacked program."""

    seed: int
    csv_path: str
    jsonl_path: str
    ckpt_path: str
    lr: Optional[float] = None  # None = PPOConfig.lr for every cell
    # Save-at-solve checkpoint (reference ppo.py:428-429 -> solved/): the
    # cell's params at the first eval that clears solved_threshold, as the
    # serial train_control saves them. None = no snapshot.
    solved_ckpt_path: Optional[str] = None


def run_stacked_study(
    cells: list[StackedCell],
    env_cfg: EnvConfig,
    ppo_cfg: PPOConfig,
    train_cfg: TrainConfig,
    updates: int,
    eval_every: int,
    eval_episodes: int,
    solved_threshold: float,
    device=None,
) -> None:
    """Train every cell at once on ``device`` (the CUDA card when None):
    chunks of ``gcd(eval_every, updates)`` stacked updates, a joint eval of
    every cell after each chunk (cell c from the stream
    ``(seed, _EVAL, i)`` that `train_control` evaluates its seed from), each
    cell's CSV and JSONL rows, and an early stop once every cell has
    cleared ``solved_threshold`` at some eval (latched per cell, as the
    serial path stops per seed; > 1 never stops). A cell's parameters are
    saved to its ``solved_ckpt_path`` at its first latching eval, and every
    cell's final parameters to its ``ckpt_path``."""
    dev = resolve_device(device)
    seeds = [c.seed for c in cells]
    lrs = [c.lr for c in cells]
    if any(lr is not None for lr in lrs):
        if any(lr is None for lr in lrs):
            raise ValueError("either every cell sets lr or none does")
    else:
        lrs = None
    model, opt, state = multiseed_init(seeds, env_cfg, ppo_cfg, train_cfg, lrs=lrs, device=dev)
    inner = max(math.gcd(eval_every, updates), 1)
    loop = make_multiseed_train_loop(model, opt, env_cfg, ppo_cfg, train_cfg, inner)
    eval_multi = make_multiseed_eval_fn(model, env_cfg, episodes=eval_episodes)

    csvs = [CSVLogger(c.csv_path, TRAIN_LOG_HEADER) for c in cells]
    jsonls = [JSONLLogger(c.jsonl_path) for c in cells]
    solved = [False] * len(cells)
    t0 = time.time()
    total_steps = 0
    total_eps_dev = None  # (S,) summed on the device
    i = 0
    while i < updates:
        state, stacked = loop(state)
        i += inner
        chunk_eps = stacked["episodes"].sum(0)
        total_eps_dev = chunk_eps if total_eps_dev is None else total_eps_dev + chunk_eps
        total_steps += inner * train_cfg.num_envs * train_cfg.rollout_steps
        gens = [torch.Generator(device=dev).manual_seed(stream(s, _EVAL, i)) for s in seeds]
        evals = {k: v.tolist() for k, v in eval_multi(gens).items()}
        eps_host = [int(x) for x in total_eps_dev.tolist()]
        hours = (time.time() - t0) / 3600.0
        now = datetime.now()
        for idx, c in enumerate(cells):
            csvs[idx].append({
                "LR": c.lr if c.lr is not None else ppo_cfg.lr,
                "Max timesteps": env_cfg.n_steps,
                "Update timesteps": train_cfg.num_envs * train_cfg.rollout_steps,
                "K epochs": ppo_cfg.k_epochs,
                "Eval episodes": eval_episodes, "Std": ppo_cfg.action_std,
                "Date": now.strftime("%d/%m/%Y"),
                "Time": now.strftime("%H:%M:%S"), "Training Count": i,
                "T hours": round(hours, 4),
                "Reward avg": evals["eval_reward"][idx],
                "Solved avg": evals["eval_solved"][idx],
                "Time avg": evals["eval_length"][idx],
                "Total Episodes": eps_host[idx],
                "Total Timesteps": total_steps,
                "ETF": round(hours / i * (updates - i), 4),
            })
            jsonls[idx].log(update=i, **{k: v[idx] for k, v in evals.items()})
        for idx, v in enumerate(evals["eval_solved"]):
            if v >= solved_threshold and not solved[idx]:
                solved[idx] = True
                if cells[idx].solved_ckpt_path:
                    # The cell's parameters at the latching eval, before any
                    # later degradation.
                    save_params(cells[idx].solved_ckpt_path, to_flax(seed_slice(model, idx)))
        n_solved = sum(solved)
        print(
            f"update {i:5d}  solved {n_solved}/{len(cells)} cells  "
            f"reward {min(evals['eval_reward']):.1f}..{max(evals['eval_reward']):.1f}  "
            f"steps/s {len(cells) * total_steps / (time.time() - t0):9.0f}"
        )
        if n_solved == len(cells):
            break
    for idx, c in enumerate(cells):
        save_params(c.ckpt_path, to_flax(seed_slice(model, idx)))
