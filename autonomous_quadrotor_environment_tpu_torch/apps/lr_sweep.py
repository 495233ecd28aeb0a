"""Learning-rate sweep: the reference's LR ablation.

Counterpart of `apps/lr_sweep.py` in the JAX package (the reference's
lr_test experiment, environment/controller/training_log/lr_test/
csv_reader_lr.py:18-74: 12 runs, LRs {1e-3, 5e-4, 1e-5} x 4 seeds, mean +/-
sigma eval-reward curves and a summary table). Each run is the
`train_control` loop without the early stop, so the curves compare;
``--stacked`` trains the whole LR x seed grid as one batched program
(`apps.stacked`, a learning rate per cell). It runs on the CUDA card
unless given ``--device cpu``.

    python -m autonomous_quadrotor_environment_tpu_torch.apps.lr_sweep \\
        --updates 1000 --out runs/lr_sweep
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..analysis.training_logs import _read_log
from . import have_matplotlib, train_control

LRS = (1e-3, 5e-4, 1e-5)  # reference csv_reader_lr.py:21


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--lrs", type=str, default=",".join(str(lr) for lr in LRS))
    p.add_argument("--seeds", type=int, default=4, help="seeds per LR")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--updates", type=int, default=1000)
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--rollout-steps", type=int, default=128)
    p.add_argument("--eval-every", type=int, default=5)
    p.add_argument("--out", type=str, default="runs/lr_sweep")
    p.add_argument("--stacked", action="store_true",
                   help="train the whole LR x seed grid as one batched program "
                   "(apps/stacked.py, a learning rate per cell in the stacked optimizer's "
                   "state); the same per-cell streams, CSV schema and full curves")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card when omitted")
    return p


def seeds_range(lr: float, seeds: int) -> range:
    return range(seeds)


def _curves(out_dir: str, size: int, lr: float, seeds: int):
    rows_per_seed = []
    for s in seeds_range(lr, seeds):
        rows = _read_log(f"{out_dir}/lr_{lr:g}/log_{size}_{s}.csv")
        rows_per_seed.append([float(r["Reward avg"]) for r in rows])
    n = min(len(r) for r in rows_per_seed)
    arr = np.asarray([r[:n] for r in rows_per_seed])
    return arr.mean(axis=0), arr.std(axis=0)


def plot_sweep(out_dir: str, size: int, lrs, seeds: int, eval_every: int) -> dict:
    """The summary table, each LR's final and best mean reward, and the band
    figure of the mean +/- sigma eval-reward curve per LR (none without
    matplotlib)."""
    curves = {lr: _curves(out_dir, size, lr, seeds) for lr in lrs}
    summary = {
        f"{lr:g}": {
            "final_reward_mean": float(mean[-1]),
            "final_reward_std": float(std[-1]),
            "best_reward_mean": float(mean.max()),
        }
        for lr, (mean, std) in curves.items()
    }
    if not have_matplotlib():
        print("(matplotlib is not installed: no lr_sweep.png)")
        return summary
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for lr, (mean, std) in curves.items():
        x = np.arange(len(mean)) * eval_every
        ax.plot(x, mean, label=f"LR: {lr:g}")
        ax.fill_between(x, mean - std, mean + std, alpha=0.4)
    ax.set_xlabel("training update")
    ax.set_ylabel("eval reward")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(f"{out_dir}/lr_sweep.png", dpi=150)
    plt.close(fig)
    return summary


def _incomplete_cells(args, lrs) -> list[tuple[float, int]]:
    """Resume: a run whose CSV holds the full curve is skipped, so a killed
    sweep restarts where it left off. A partial curve restarts clean, its
    JSONL (which appends) and in-progress checkpoint removed too."""
    rows_done = args.updates // args.eval_every
    todo = []
    for lr in lrs:
        for s in seeds_range(lr, args.seeds):
            csv_path = f"{args.out}/lr_{lr:g}/log_{args.size}_{s}.csv"
            if os.path.exists(csv_path):
                with open(csv_path) as f:
                    if sum(1 for _ in f) - 1 >= rows_done:
                        print(f"===== lr {lr:g} seed {s} (done, skipping) =====")
                        continue
                os.remove(csv_path)
                for stale in (
                    f"{args.out}/lr_{lr:g}/train_{args.size}_{s}.jsonl",
                    f"{args.out}/lr_{lr:g}/untrained_networks/nn_{args.size}_{s}.msgpack",
                ):
                    if os.path.exists(stale):
                        os.remove(stale)
            todo.append((lr, s))
    return todo


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    lrs = [float(x) for x in args.lrs.split(",")]
    os.makedirs(args.out, exist_ok=True)
    todo = _incomplete_cells(args, lrs)
    if args.stacked and todo:
        from ..config import EnvConfig, PPOConfig, TrainConfig
        from .stacked import StackedCell, run_stacked_study

        print(f"===== stacked LR sweep: {len(todo)} cells in one program =====")
        for lr, _s in todo:
            os.makedirs(f"{args.out}/lr_{lr:g}/untrained_networks", exist_ok=True)
        cells = [
            StackedCell(
                seed=s, lr=lr,
                csv_path=f"{args.out}/lr_{lr:g}/log_{args.size}_{s}.csv",
                jsonl_path=f"{args.out}/lr_{lr:g}/train_{args.size}_{s}.jsonl",
                ckpt_path=f"{args.out}/lr_{lr:g}/untrained_networks/nn_{args.size}_{s}.msgpack",
            )
            for lr, s in todo
        ]
        run_stacked_study(
            cells, EnvConfig(n_steps=1000), PPOConfig(),
            TrainConfig(num_envs=args.num_envs, rollout_steps=args.rollout_steps,
                        network_size=args.size, updates=args.updates,
                        eval_every=args.eval_every),
            updates=args.updates, eval_every=args.eval_every, eval_episodes=40,
            solved_threshold=1.1,  # never stop early: full curves
            device=args.device,
        )
    else:
        for lr, s in todo:
            print(f"===== lr {lr:g} seed {s} =====")
            train_control.main([
                "--seed", str(s), "--size", str(args.size), "--lr", str(lr),
                "--updates", str(args.updates), "--num-envs", str(args.num_envs),
                "--rollout-steps", str(args.rollout_steps),
                "--eval-every", str(args.eval_every),
                "--solved-threshold", "1.1",  # never stop early: full curves
                "--out", f"{args.out}/lr_{lr:g}",
            ] + ([] if args.device is None else ["--device", args.device]))
    summary = plot_sweep(args.out, args.size, lrs, args.seeds, args.eval_every)
    with open(f"{args.out}/summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
