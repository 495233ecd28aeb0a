"""The learning gate of the stacked seed study and of data-parallel
training on the CUDA card, from scratch at the trainer's own defaults.

    python3 scripts/study_curve.py --out DIR [--seeds 4] [--dp N]

(a) stacked: `apps.seed_study.main --stacked --seeds 4` (1024 envs x 128
    steps per seed, K=10, full batch, a 40-episode eval of every seed every
    5 updates from the stream `train_control` evaluates that seed from),
    stopping once every seed has read eval_solved >= 0.8 (its
    --solved-threshold), at most 600 updates. The gate: each seed's first
    eval >= 0.8 by update 600.
(b) dp: `apps.train_control.main --dp N` (N ranks, one card each over
    NCCL; N = every card when not given), the same defaults and stop, to
    the same gate.
(c) serial: `apps.train_control.main` of seed 0, the same defaults and
    stop: the wall clock that (a) is compared with, 4 times over.

It prints one JSON line per arm (first update >= 0.8 per seed, wall
seconds) and a summary line with the card's name and power limit, which
it also writes to DIR/summary.json, and exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from autonomous_quadrotor_environment_tpu_torch.apps import (  # noqa: E402
    seed_study,
    train_control,
)

SOLVED, BY, EVAL_EVERY = 0.8, 600, 5


def first_solved(csv_path: str):
    """The first update whose eval reads eval_solved >= SOLVED, or None."""
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            if float(row["Solved avg"]) >= SOLVED:
                return int(float(row["Training Count"]))
    return None


def timed(fn, argv: list) -> float:
    t0 = time.perf_counter()
    fn(argv)
    return time.perf_counter() - t0


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--seeds", type=int, default=4)
    p.add_argument("--dp", type=int, default=0, help="ranks of the dp arm (0: every card)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("study_curve: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    common = ["--updates", str(BY), "--eval-every", str(EVAL_EVERY),
              "--solved-threshold", str(SOLVED)]
    summary = {"card": card, "solved": SOLVED, "by_update": BY}

    out = os.path.join(args.out, "stacked")
    seconds = timed(seed_study.main, ["--stacked", "--seeds", str(args.seeds), "--out", out]
                    + common)
    firsts = [first_solved(os.path.join(out, f"log_128_{s}.csv")) for s in range(args.seeds)]
    summary["stacked"] = {"seeds": args.seeds, "first_solved": firsts, "seconds": seconds}
    print(json.dumps({"stacked": summary["stacked"]}), flush=True)

    world = args.dp or torch.cuda.device_count()
    out = os.path.join(args.out, "dp")
    seconds = timed(train_control.main, ["--dp", str(world), "--out", out] + common)
    summary["dp"] = {"world": world, "first_solved": first_solved(
        os.path.join(out, "log_128_0.csv")), "seconds": seconds}
    print(json.dumps({"dp": summary["dp"]}), flush=True)

    out = os.path.join(args.out, "serial")
    seconds = timed(train_control.main, ["--out", out] + common)
    summary["serial"] = {"first_solved": first_solved(os.path.join(out, "log_128_0.csv")),
                         "seconds": seconds}
    summary["stacked_vs_serial_x_seeds"] = (
        summary["stacked"]["seconds"] / (args.seeds * summary["serial"]["seconds"]))
    gate = [f is not None and f <= BY for f in firsts + [summary["dp"]["first_solved"]]]
    summary["gate"] = all(gate)
    print(json.dumps(summary), flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return 0 if summary["gate"] else 1


if __name__ == "__main__":
    sys.exit(main())
