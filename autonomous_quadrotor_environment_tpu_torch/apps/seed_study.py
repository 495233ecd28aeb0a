"""Multi-seed controller-training robustness study.

Counterpart of `apps/seed_study.py` in the JAX package (the reference's
30-seed velocity-training study, environment/controller/results/seeds/
velocity_training/, analyzed by logger_analyzer.py:45-97: episodes and
flight hours until solved, with 1-sigma spreads). Each seed runs the
`train_control` loop, stopping at the solved threshold; the per-seed CSV
logs give the aggregate statistics and the distribution figure.

    python -m autonomous_quadrotor_environment_tpu_torch.apps.seed_study \\
        --seeds 30 --out runs/seed_study

``--stacked`` trains every seed at once as one batched program
(`agents.multiseed` through `apps.stacked`) on one card, with each seed's
generator streams and CSV schema. It runs on the CUDA card unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

from ..analysis.training_logs import episodes_to_solve, flight_hours_to_solve
from . import have_matplotlib, train_control


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seeds", type=int, default=30)
    p.add_argument("--start-seed", type=int, default=0)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--updates", type=int, default=2000)
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--rollout-steps", type=int, default=128)
    p.add_argument("--eval-every", type=int, default=10)
    p.add_argument("--out", type=str, default="runs/seed_study")
    p.add_argument("--task", type=str, default="hover", choices=("hover", "velocity"),
                   help="velocity = the reference's 30-seed task family "
                   "(results/seeds/velocity_training/, logger_analyzer.py:51-97)")
    p.add_argument("--vel-target-max", type=float, default=1.0)
    p.add_argument("--reward-threshold", type=float, default=None,
                   help="episodes_to_solve eval-reward gate; default uses the solved-fraction "
                   "stop in train_control")
    p.add_argument("--stacked", action="store_true",
                   help="train all seeds at once as one batched program (agents/multiseed.py); "
                   "the same per-seed streams and CSV schema as the serial path; evals and the "
                   "stop are joint every --eval-every updates, and the study ends when every "
                   "seed has solved")
    p.add_argument("--eval-episodes", type=int, default=40)
    p.add_argument("--solved-threshold", type=float, default=0.95)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card when omitted")
    return p


def aggregate(out_dir: str, size: int, seeds: list[int], dt: float = 0.01) -> dict:
    """Episodes and flight hours to solve across seeds (reference
    logger_analyzer.py:91-97 prints the mean +/- 1 sigma of both)."""
    eps, hours, unsolved = [], [], []
    for s in seeds:
        path = f"{out_dir}/log_{size}_{s}.csv"
        if not os.path.exists(path):
            unsolved.append(s)
            continue
        e = episodes_to_solve(path, solved_threshold=0.95)
        h = flight_hours_to_solve(path, dt=dt, solved_threshold=0.95)
        if e is None:
            unsolved.append(s)
        else:
            eps.append(e)
            hours.append(h)
    return {
        "seeds": len(seeds),
        "solved_seeds": len(eps),
        "unsolved_seeds": unsolved,
        "episodes_to_solve_mean": float(np.mean(eps)) if eps else None,
        "episodes_to_solve_std": float(np.std(eps)) if eps else None,
        "flight_hours_mean": float(np.mean(hours)) if hours else None,
        "flight_hours_std": float(np.std(hours)) if hours else None,
        "episodes_to_solve": eps,
        "flight_hours": hours,
    }


def plot_distribution(summary: dict, out_path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    eps = summary["episodes_to_solve"]
    if not eps:
        return
    fig, axs = plt.subplots(1, 2, figsize=(9, 3.5))
    axs[0].hist(eps, bins=10, color="tab:blue", alpha=0.8)
    axs[0].set_xlabel("episodes until solved")
    axs[0].set_ylabel("seeds")
    axs[0].grid(True, alpha=0.3)
    axs[1].hist(summary["flight_hours"], bins=10, color="tab:orange", alpha=0.8)
    axs[1].set_xlabel("simulated flight hours until solved")
    axs[1].grid(True, alpha=0.3)
    fig.suptitle(
        f"{summary['solved_seeds']}/{summary['seeds']} seeds solved; "
        f"episodes {summary['episodes_to_solve_mean']:.0f}"
        f"±{summary['episodes_to_solve_std']:.0f}, "
        f"flight {summary['flight_hours_mean']:.2f}"
        f"±{summary['flight_hours_std']:.2f} h"
    )
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def _ran_full_budget(csv_path: str, updates: int) -> bool:
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    return bool(rows) and int(float(rows[-1]["Training Count"])) >= updates


def _unsolved_seeds(args, seeds: list[int]) -> list[int]:
    """Resume: a seed whose CSV shows a solved run, or one that ran the full
    update budget unsolved (an outcome for small networks in the size
    sweep), is skipped, so a killed study restarts cleanly; stale partial
    logs are removed."""
    remaining = []
    for s in seeds:
        csv_path = f"{args.out}/log_{args.size}_{s}.csv"
        if os.path.exists(csv_path):
            if episodes_to_solve(csv_path, solved_threshold=args.solved_threshold) is not None:
                print(f"(seed {s} already solved, skipping)")
                continue
            if _ran_full_budget(csv_path, args.updates):
                print(f"(seed {s} ran the full budget unsolved, skipping)")
                continue
            os.remove(csv_path)
            stale = f"{args.out}/train_{args.size}_{s}.jsonl"
            if os.path.exists(stale):
                os.remove(stale)
        remaining.append(s)
    return remaining


def run_stacked(args, seeds: list[int]) -> None:
    """The whole study as one batched program (`apps.stacked`): chunks of
    --eval-every stacked updates, a joint per-seed eval after each, per-seed
    CSV and JSONL rows in the reference schema, an early stop when every
    seed has solved."""
    from ..config import EnvConfig, PPOConfig, TrainConfig
    from .stacked import StackedCell, run_stacked_study

    vel_max = (args.vel_target_max,) * 3 if args.task == "velocity" else (0.0, 0.0, 0.0)
    env_cfg = EnvConfig(n_steps=1000, vel_target_max=vel_max)
    train_cfg = TrainConfig(
        num_envs=args.num_envs, rollout_steps=args.rollout_steps, network_size=args.size,
        updates=args.updates, eval_every=args.eval_every, eval_episodes=args.eval_episodes,
    )
    os.makedirs(f"{args.out}/solved", exist_ok=True)
    cells = [
        StackedCell(
            seed=s,
            csv_path=f"{args.out}/log_{args.size}_{s}.csv",
            jsonl_path=f"{args.out}/train_{args.size}_{s}.jsonl",
            ckpt_path=f"{args.out}/nn_final_{args.size}_{s}.msgpack",
            # the serial train_control's layout: {out}/solved/nn_solved_{size}_{seed}
            solved_ckpt_path=f"{args.out}/solved/nn_solved_{args.size}_{s}.msgpack",
        )
        for s in seeds
    ]
    run_stacked_study(cells, env_cfg, PPOConfig(), train_cfg, updates=args.updates,
                      eval_every=args.eval_every, eval_episodes=args.eval_episodes,
                      solved_threshold=args.solved_threshold, device=args.device)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    seeds = list(range(args.start_seed, args.start_seed + args.seeds))
    remaining = _unsolved_seeds(args, seeds)
    if args.stacked:
        if remaining:
            print(f"===== stacked study: {len(remaining)} seeds in one program =====")
            run_stacked(args, remaining)
    else:
        for s in remaining:
            print(f"===== seed {s} =====")
            train_control.main([
                "--seed", str(s), "--size", str(args.size),
                "--updates", str(args.updates), "--num-envs", str(args.num_envs),
                "--rollout-steps", str(args.rollout_steps),
                "--task", args.task, "--vel-target-max", str(args.vel_target_max),
                "--eval-every", str(args.eval_every), "--out", args.out,
            ] + ([] if args.device is None else ["--device", args.device]))
    summary = aggregate(args.out, args.size, seeds)
    with open(f"{args.out}/summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    if have_matplotlib():
        plot_distribution(summary, f"{args.out}/seed_study.png")
    else:
        print("(matplotlib is not installed: no seed_study.png)")
    print(json.dumps({k: v for k, v in summary.items() if not isinstance(v, list)}, indent=2))
    return summary


if __name__ == "__main__":
    main()
