"""The state controller's from-scratch curves at the trainer's own defaults
on the CUDA card, calm and robust, each then cross-evaluated at 256
episodes.

    python3 scripts/control_curve.py --out DIR [--arms calm,robust]

(a) calm: `apps.train_control.main` at its defaults (1024 envs x 128
    steps, K=10, full batch, autograd update, a 40-episode eval every 5
    updates) from seed 0 for at most ``--calm-updates`` (600) updates; the
    gate: an eval with eval_solved >= 0.8 by update 600. Then
    `apps.robust_eval.main` flies the final checkpoint at 256 episodes.
(b) robust: the JAX package's documented curriculum (RESULTS.md, "Robust
    control"): ``--robust --curriculum 0,0.33,0.66,1.0 --updates 2000
    --eval-every 20`` from seed 0 (the evals draw from their own
    generator stream, so their cadence changes nothing in training); then
    `apps.robust_eval.main --nominal <solved fixture> --robust <its final
    checkpoint>` at 256 episodes. The gate: robust/windy eval_solved >=
    0.10 and robust/calm eval_solved >= 0.8.

Each arm runs through `run_train_control`, which times every update and
eval. The script prints one JSON line per eval (arm, update,
eval_solved, eval_station_keeping, seconds from the start) and a summary
line per arm with the wall time, the warm and median ms of an update and an
eval, the cross-eval's table and seconds and the gate, which it also
writes to DIR/summary.json. It exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from autonomous_quadrotor_environment_tpu_torch.apps import robust_eval  # noqa: E402
from autonomous_quadrotor_environment_tpu_torch.fixtures import SOLVED_CONTROLLER  # noqa: E402

CALM_SOLVED, CALM_BY = 0.8, 600
ROBUST_WINDY_SOLVED, ROBUST_CALM_SOLVED = 0.10, 0.8
EPISODES = 256


def run_train_control(argv: list) -> dict:
    """`apps.train_control.main(argv)` with every launch counter set to 0
    just before and read just after, and each train step (rollout and
    update) and eval timed by the host clock between synchronizations.
    Returns the app's result, the launches, each step's and eval's ms and
    the seconds from the start at which each eval ended."""
    from autonomous_quadrotor_environment_tpu_torch.apps import train_control

    ms, eval_at_s = {"update": [], "eval": []}, []

    def timed(name, fn):
        def call(*args, **kwargs):
            chip_smoke.sync()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            chip_smoke.sync()
            ms[name].append((time.perf_counter() - t) * 1e3)
            if name == "eval":
                eval_at_s.append(time.perf_counter() - t0)
            return out
        return call

    make_step, make_eval = train_control.make_train_step, train_control.make_eval_fn
    train_control.make_train_step = lambda *a, **k: timed("update", make_step(*a, **k))
    train_control.make_eval_fn = lambda *a, **k: timed("eval", make_eval(*a, **k))
    t0 = time.perf_counter()
    try:
        chip_smoke.zero_counters()
        result = train_control.main(argv)
        chip_smoke.sync()
        launches = chip_smoke.read_counters()
    finally:
        train_control.make_train_step, train_control.make_eval_fn = make_step, make_eval
    warm = ms["update"][1:]
    return {"result": result, "launches": launches, "update_ms": ms["update"],
            "eval_ms": ms["eval"], "eval_at_s": eval_at_s,
            "warm_update_ms": sum(warm) / len(warm) if warm else None,
            "median_update_ms": sorted(ms["update"])[len(ms["update"]) // 2],
            "median_eval_ms": sorted(ms["eval"])[len(ms["eval"]) // 2] if ms["eval"] else None}


def run_arm(name: str, argv: list, out: str) -> tuple[dict, list]:
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    run = run_train_control(argv + ["--seed", "0", "--out", out])
    wall_s = time.perf_counter() - t0
    log = os.path.join(out, "train_128_0.jsonl")
    rows = []
    if os.path.exists(log):  # written at the first eval
        with open(log) as f:
            rows = [json.loads(line) for line in f]
    for row, at in zip(rows, run["eval_at_s"]):
        chip_smoke.emit({"arm": name, "update": row["update"], "eval_solved": row["eval_solved"],
                         "eval_station_keeping": row["eval_station_keeping"], "seconds": at})
    return {"argv": argv, "train_wall_s": wall_s, "updates": len(run["update_ms"]),
            "warm_update_ms": run["warm_update_ms"], "median_update_ms": run["median_update_ms"],
            "median_eval_ms": run["median_eval_ms"], "launches": run["launches"],
            "final_eval": run["result"]["final_eval"]}, rows


def cross_eval(argv: list) -> tuple[dict, float]:
    chip_smoke.sync()
    t = time.perf_counter()
    table = robust_eval.main(argv + ["--episodes", str(EPISODES), "--seed", "0"])
    chip_smoke.sync()
    return table, time.perf_counter() - t


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--arms", default="calm,robust")
    p.add_argument("--calm-updates", type=int, default=CALM_BY)
    p.add_argument("--robust-updates", type=int, default=2000)
    args = p.parse_args()
    summary, ok = {"card": chip_smoke.card()}, True
    if "calm" in args.arms.split(","):
        out = os.path.join(args.out, "calm")
        arm, rows = run_arm("calm", ["--updates", str(args.calm_updates)], out)
        arm["first_update_reaching_gate"] = next(
            (r["update"] for r in rows if r["eval_solved"] >= CALM_SOLVED), None)
        arm["gate"] = {"eval_solved": CALM_SOLVED, "by_update": CALM_BY}
        arm["cross_eval"], arm["cross_eval_s"] = cross_eval(
            ["--nominal", os.path.join(out, "nn_final_128_0.msgpack")])
        arm["passed"] = (arm["first_update_reaching_gate"] or CALM_BY + 1) <= CALM_BY
        summary["calm"] = arm
        ok &= arm["passed"]
        chip_smoke.emit({"arm": "calm", **{k: v for k, v in arm.items() if k != "argv"}})
    if "robust" in args.arms.split(","):
        out = os.path.join(args.out, "robust")
        arm, rows = run_arm("robust", ["--robust", "--curriculum", "0,0.33,0.66,1.0",
                                       "--updates", str(args.robust_updates),
                                       "--eval-every", "20"], out)
        arm["cross_eval"], arm["cross_eval_s"] = cross_eval(
            ["--nominal", SOLVED_CONTROLLER, "--robust",
             os.path.join(out, "nn_final_128_0.msgpack")])
        arm["gate"] = {"robust/windy eval_solved": ROBUST_WINDY_SOLVED,
                       "robust/calm eval_solved": ROBUST_CALM_SOLVED}
        arm["passed"] = (arm["cross_eval"]["robust/windy"]["eval_solved"] >= ROBUST_WINDY_SOLVED
                         and arm["cross_eval"]["robust/calm"]["eval_solved"]
                         >= ROBUST_CALM_SOLVED)
        summary["robust"] = arm
        ok &= arm["passed"]
        chip_smoke.emit({"arm": "robust", **{k: v for k, v in arm.items() if k != "argv"}})
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
