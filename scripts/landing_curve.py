"""The landing trainer's quality gate on the CUDA card: train the visual-
landing policy from scratch, then fly its best checkpoint on the
100-episode landing benchmark.

    python3 scripts/landing_curve.py --out DIR

runs `apps.train_landing.main` at its shipped defaults (bf16 convolutions,
space-to-depth, float32 images, per-row shuffle, 20-episode evals) with
``--num-envs 128 --rollout-steps 24 --inner 10 --eval-every 100 --updates
800 --seed 0``, the shape of the JAX package's certified ablation runs
(runs/r5/ablation/*/train_landing_0.jsonl), through
`chip_smoke.run_train_landing`, which times each rollout, reset pool,
update and eval; then `apps.eval_landing.main` on the best checkpoint at
100 episodes, seed 0. It prints one JSON line per eval (update,
eval_solved, eval_reward, seconds from the start), and a last line with
the wall time, the warm ms of each piece, the launches and the
benchmark's result, which it also writes to DIR/summary.json. The gate
passes when an eval reaches eval_solved >= 0.75; the script exits 1
otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from autonomous_quadrotor_environment_tpu_torch.apps import eval_landing  # noqa: E402
from autonomous_quadrotor_environment_tpu_torch.fixtures import SOLVED_CONTROLLER  # noqa: E402

GATE = 0.75


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--updates", type=int, default=800)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    argv = ["--controller", SOLVED_CONTROLLER, "--num-envs", "128", "--rollout-steps", "24",
            "--inner", "10", "--eval-every", "100", "--updates", str(args.updates),
            "--seed", str(args.seed), "--out", args.out]
    t0 = time.perf_counter()
    run = chip_smoke.run_train_landing(argv)
    wall_s = time.perf_counter() - t0
    run.pop("model")
    with open(os.path.join(args.out, f"train_landing_{args.seed}.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for row, at in zip(rows, run["eval_at_s"]):
        chip_smoke.emit({"update": row["update"], "eval_solved": row["eval_solved"],
                         "eval_reward": row["eval_reward"], "seconds": at})
    best = os.path.join(args.out, f"PPO_landing_best_{args.seed}.msgpack")
    t1 = time.perf_counter()
    bench = eval_landing.main(["--controller", SOLVED_CONTROLLER, "--policy", best,
                               "--episodes", "100", "--seed", "0"])
    summary = {
        "card": chip_smoke.card(), "argv": argv[:-2], "train_wall_s": wall_s,
        "first_update_reaching_gate": next(
            (r["update"] for r in rows if r["eval_solved"] >= GATE), None),
        "gate": GATE, "best_checkpoint_benchmark": bench,
        "benchmark_seconds": time.perf_counter() - t1, **run,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f)
    chip_smoke.emit({k: v for k, v in summary.items() if not k.endswith("_ms")} | {
        k: v for k, v in summary.items() if k.startswith("warm_")})
    return 0 if summary["first_update_reaching_gate"] is not None else 1


if __name__ == "__main__":
    sys.exit(main())
