"""Time the rollout kernel (B1), the render kernel (B5) and the wide designs of
B1-B4 of two checkouts of this repository on one CUDA card, in turns: the
other tree, this one, this one, the other (each turn a process of its own,
which builds that tree's kernels into its own `build/`, all at once, and
imports that tree's package).

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
sets the time between events); the wide designs at the shapes PERF.md
times them, on seeded weights and rows: B1 at hidden 512, 768 and 1024 at
8192 x 256 and at 768 and 1024 at kernel_options' 1024 x 32, B2 at 512 and
1024 on a bench.py minibatch (512 blocks of 1024 of seeded (256, 75, 8192)
rows), B3 at 1024 and B4 at 512 on 16,384 seeded rows (tile 128, every
block), each by CUDA events over 5 launches after 2; and B2's loss pass
(`loss_kernel` of `ppo_grad_wide.cuh`) alone at 512 and 1024 on that
minibatch, its device time per launch of B2 from torch.profiler over 5.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROLLOUTS = ((8192, 256), (1024, 128))
RENDERS = ((100, 200), (4096, 50))
WIDE_ROWS = 16384  # B3's and B4's rows, as kernel_options' row-major steps time them
WIDE_ROLLOUTS = ((512, 8192, 256), (768, 8192, 256), (1024, 8192, 256), (768, 1024, 32),
                 (1024, 1024, 32))  # B1's (hidden, B, T)


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

    libs = [smoke._lib("rollout_fused", 128), ("render_nadir", ()),
            smoke._lib("rollout_fused", 512), smoke._lib("ppo_fused_t", 512),
            smoke._lib("ppo_fused", 512)]
    with smoke.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: smoke._build.build(*lib), libs))
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
    out.update(wide_times(smoke, cfg))
    out["card"] = smoke.card()
    return out


def wide_times(smoke, cfg) -> dict:
    """The wide designs' times (see the module's docstring)."""
    torch, kw = smoke.torch, dict(compute_dtype="f32", **smoke.ROW_KW)
    out = {}
    for hidden, b, steps in WIDE_ROLLOUTS:
        gen = torch.Generator(device=smoke.DEVICE).manual_seed(1)
        inputs = smoke.fused_inputs(smoke._model(hidden, 11), smoke.hover.reset(gen, cfg, n=b),
                                    gen, cfg, steps, 4)
        out[f"b1_wide{hidden}_{b}x{steps}_ms"] = smoke.time_cuda(
            lambda: smoke.rf.fused_rollout(*inputs, cfg, smoke.ACTION_STD), 2, 5)
        del inputs
    obs, aux, g = smoke._seeded_t(256, 8192, 41)
    blocks = torch.randperm(2048, generator=g, device=smoke.DEVICE)[:512].to(torch.int32)
    for hidden in (512, 1024):
        m = smoke._model(hidden, 42)
        call = lambda: smoke.pf.fused_ppo_grad_t(m, obs, aux, blocks, tile=1024, **kw)
        out[f"b2_wide{hidden}_minibatch_ms"] = smoke.time_cuda(call, 2, 5)
        out[f"b2_wide{hidden}_loss_pass_device_ms"] = smoke.device_ms_per_call(
            call, "loss_kernel", 5)
    model = smoke._model(512, 42)
    del obs, aux
    obs, aux, _ = smoke._seeded_rows(WIDE_ROWS, 75, 45)
    every = torch.arange(WIDE_ROWS // 128, device=smoke.DEVICE, dtype=torch.int32)
    wide = smoke._model(1024, 44)
    out["b3_wide1024_16384_ms"] = smoke.time_cuda(
        lambda: smoke.pr.fused_ppo_grad(wide, obs, aux, every, tile=128, **kw), 2, 5)
    m_adam = copy.deepcopy(model)
    opt = torch.optim.Adam(m_adam.parameters(), lr=smoke.LEARN_LR, eps=1e-8)
    out["b4_wide512_16384_ms"] = smoke.time_cuda(
        lambda: smoke.pr.fused_ppo_grad_adam(m_adam, opt, obs, aux, every, tile=128, **kw), 2, 5)
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

    def mean(tree):  # a profiler time that was not measured stays its note
        got = {k: [t[k] for t in turns if t["tree"] == tree] for k in keys}
        return {k: sum(v) / 2 if all(isinstance(x, float) for x in v) else v
                for k, v in got.items()}

    print(json.dumps({"card": turns[-1]["card"], "other": mean(other), "this": mean(HERE),
                      "order": [t["tree"] for t in turns]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
