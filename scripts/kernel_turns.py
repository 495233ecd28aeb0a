"""Time the rollout kernel (B1) and the render kernel (B5) of two checkouts of
this repository on one CUDA card, in turns: the other tree, this one, this
one, the other (each turn a process of its own, which builds that tree's
kernels into its own `build/` and imports that tree's package).

    python3 scripts/kernel_turns.py --other DIR

DIR is another checkout, for example a parent commit from `git archive`
unpacked into a directory that .gitignore lists. Each turn prints one JSON
line; the last line holds both trees' mean milliseconds per shape, the
card's name and power limit. Both trees time the same work, with this
tree's `chip_smoke.py` helpers and seeds: B1 with the shipped solved
controller at bench.py's shape (8192 envs x 256 steps, a 4-deep pool) and
at the trainer's (1024 x 128), by CUDA events over 5 launches after 2; B5
on `chip_smoke.render_poses` at the landing eval's batch (100) and at 4096,
over 200 and 50 launches after 10, and its device time per launch from
torch.profiler over as many (at B=100 the host's launch, not the kernel,
sets the time between events).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROLLOUTS = ((8192, 256), (1024, 128))
RENDERS = ((100, 200), (4096, 50))


def turn(tree: str) -> dict:
    """One tree's times, in this process: that tree's package, this tree's
    `chip_smoke.py` (loaded by path, so a checkout's own copy is not used)."""
    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(smoke.rf.__file__)))
    if pkg_root != os.path.abspath(tree):
        raise RuntimeError(f"imported the package from {pkg_root}, not from {tree}")

    out = {"tree": tree}
    cfg = smoke.EnvConfig()
    model = smoke.load_solved_controller(smoke.DEVICE)
    for b, steps in ROLLOUTS:
        gen = smoke.torch.Generator(device=smoke.DEVICE).manual_seed(1)
        states = smoke.hover.reset(gen, cfg, n=b)
        inputs = smoke.fused_inputs(model, states, gen, cfg, steps, 4)
        out[f"b1_{b}x{steps}_ms"] = smoke.time_cuda(
            lambda: smoke.rf.fused_rollout(*inputs, cfg, smoke.ACTION_STD), 2, 5)
    for b, runs in RENDERS:
        quad, marker, bright = smoke.render_poses(b, seed=20 + b)
        call = lambda: smoke.rk.render_nadir_batch(quad, marker, brightness=bright)
        out[f"b5_{b}_ms"] = smoke.time_cuda(call, 10, runs)
        out[f"b5_{b}_device_ms"] = smoke.device_ms_per_call(call, "render_nadir", runs)
    out["card"] = smoke.card()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other checkout, timed first and last")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # one turn, in a child process
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(turn(args.tree)), flush=True)
        return 0
    if not args.other:
        ap.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device is available", file=sys.stderr)
        return 1
    other = os.path.abspath(args.other)
    turns = []
    for tree in (other, HERE, HERE, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            raise RuntimeError(f"the turn of {tree} failed ({proc.returncode})")
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    keys = [k for k in turns[0] if k not in ("tree", "card")]
    mean = lambda tree: {k: sum(t[k] for t in turns if t["tree"] == tree) / 2 for k in keys}
    print(json.dumps({"card": turns[-1]["card"], "other": mean(other), "this": mean(HERE),
                      "order": [t["tree"] for t in turns]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
