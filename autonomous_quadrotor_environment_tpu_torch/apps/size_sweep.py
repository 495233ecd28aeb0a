"""Network-size sweep: the reference's headline experiment, one command.

Counterpart of `apps/size_sweep.py` in the JAX package (the reference's
5 sizes x 4 seeds training-log grid, environment/controller/training_log/
log_{016..256}_*.csv, 20 cluster runs, read into mean +/- std reward bands
by training_log/csv_reader.py:17-69). Each size trains its seeds serially
(`train_control` per seed) or stacked, all seeds of a size as one batched
program (``--stacked``, `apps.stacked`); then the band figure and the
per-size aggregates are written. It runs on the CUDA card unless given
``--device cpu``.

    python -m autonomous_quadrotor_environment_tpu_torch.apps.size_sweep \\
        --stacked --out runs/sweep
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

from ..analysis.training_logs import episodes_to_solve
from . import have_matplotlib


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--sizes", type=str, default="16,32,64,128,256")
    p.add_argument("--seeds", type=int, default=4, help="seeds per size")
    p.add_argument("--updates", type=int, default=2500)
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--rollout-steps", type=int, default=32)
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--eval-episodes", type=int, default=40)
    p.add_argument("--solved-threshold", type=float, default=0.95)
    p.add_argument("--out", type=str, default="runs/sweep")
    p.add_argument("--stacked", action="store_true",
                   help="train each size's seeds at once as one batched program "
                   "(apps/stacked.py)")
    p.add_argument("--figure", type=str, default="docs/size_sweep_reward.png",
                   help="band-figure output path (the reference's csv_reader.py figure)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card when omitted")
    return p


def band_table(out_dir: str, sizes: list[int], seeds: list[int],
               solved_threshold: float = 0.95) -> dict:
    """The per-size table that `analysis.plots.sweep_band_figure` returns
    beside its figure (seeds, seeds solved, the final reward's mean and std
    over the seeds, the mean episode count), for a machine without
    matplotlib."""
    summary = {}
    for size in sizes:
        finals, solved, episodes = [], [], []
        for seed in seeds:
            path = os.path.join(out_dir, f"log_{size}_{seed}.csv")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                rows = list(csv.DictReader(f))
            if not rows:
                continue
            finals.append(float(rows[-1]["Reward avg"]))
            solved.append(any(float(r["Solved avg"]) >= solved_threshold for r in rows))
            episodes.append(int(rows[-1]["Total Episodes"]))
        if finals:
            summary[str(size)] = {
                "seeds": len(finals),
                "solved_seeds": int(np.sum(solved)),
                "final_reward_mean": float(np.mean(finals)),
                "final_reward_std": float(np.std(finals)),
                "episodes_mean": float(np.mean(episodes)),
            }
    return summary


def run_done(csv_path: str, updates: int, solved_threshold: float) -> bool:
    """A run is complete if it solved or used its whole update budget."""
    if not os.path.exists(csv_path):
        return False
    if episodes_to_solve(csv_path, solved_threshold=solved_threshold) is not None:
        return True
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    return bool(rows) and int(float(rows[-1]["Training Count"])) >= updates


def sweep_size(args, size: int, todo: list[int]) -> None:
    for seed in todo:
        for stale in (f"{args.out}/log_{size}_{seed}.csv",
                      f"{args.out}/train_{size}_{seed}.jsonl"):
            if os.path.exists(stale):
                os.remove(stale)
    if args.stacked:
        from ..config import EnvConfig, PPOConfig, TrainConfig
        from .stacked import StackedCell, run_stacked_study

        os.makedirs(f"{args.out}/solved", exist_ok=True)
        cells = [
            StackedCell(
                seed=s,
                csv_path=f"{args.out}/log_{size}_{s}.csv",
                jsonl_path=f"{args.out}/train_{size}_{s}.jsonl",
                ckpt_path=f"{args.out}/nn_final_{size}_{s}.msgpack",
                # the serial train_control layout
                solved_ckpt_path=f"{args.out}/solved/nn_solved_{size}_{s}.msgpack",
            )
            for s in todo
        ]
        run_stacked_study(
            cells, EnvConfig(n_steps=1000), PPOConfig(),
            TrainConfig(num_envs=args.num_envs, rollout_steps=args.rollout_steps,
                        network_size=size, updates=args.updates, eval_every=args.eval_every,
                        eval_episodes=args.eval_episodes),
            updates=args.updates, eval_every=args.eval_every,
            eval_episodes=args.eval_episodes, solved_threshold=args.solved_threshold,
            device=args.device,
        )
    else:
        from . import train_control

        for seed in todo:
            train_control.main([
                "--seed", str(seed), "--size", str(size),
                "--updates", str(args.updates), "--num-envs", str(args.num_envs),
                "--rollout-steps", str(args.rollout_steps),
                "--eval-every", str(args.eval_every),
                "--eval-episodes", str(args.eval_episodes),
                "--inner", str(args.eval_every), "--out", args.out,
            ] + ([] if args.device is None else ["--device", args.device]))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    sizes = [int(x) for x in args.sizes.split(",")]
    seeds = list(range(args.seeds))
    os.makedirs(args.out, exist_ok=True)
    for size in sizes:
        todo = [s for s in seeds
                if not run_done(f"{args.out}/log_{size}_{s}.csv", args.updates,
                                args.solved_threshold)]
        if not todo:
            print(f"(size {size}: all seeds complete, skipping)")
            continue
        print(f"===== size {size} seeds {todo}{' (stacked)' if args.stacked else ''} =====")
        sweep_size(args, size, todo)
    if have_matplotlib():
        from ..analysis.plots import sweep_band_figure

        summary = sweep_band_figure(args.out, sizes, seeds, args.figure)
    else:
        print(f"(matplotlib is not installed: no figure at {args.figure})")
        summary = band_table(args.out, sizes, seeds)
    with open(f"{args.out}/summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
