"""The readings the limits of `correct` are set from, for one cell, in one
process on the card, at the cell's own size and without a measured window:

* the program's sound runs on each of ``--seeds`` (the lower readings);
* the control, the reference computed in the precision below the one the
  configuration states, on each of ``--control-seeds`` (the upper ones);
* each fault of ``--faults`` planted in the program, on each of
  ``--fault-seeds``: ``unchanged_state`` (every train step returns the
  model as it was), or a fault the cell's driver defines by that name, as
  ``half_batch`` (each minibatch's mean over half its rows) or, in the
  hover driver, ``bf16_update`` (kernel B2's products in bf16).

Each is compared with the reference on the same seed, as a run compares.

    python3 portbench/limits.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --faults half_batch --fault-seeds 1,2,3 --out FILE
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=ints, default=[])
    p.add_argument("--control-seeds", type=ints, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=ints, default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import run as bench_run

    bench_run.caches(ROOT)
    import torch

    from portbench import harness

    cell = harness.find_cell(args.workload, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from autonomous_quadrotor_environment_tpu_torch.utils.cache import (
            enable_compilation_cache)

        enable_compilation_cache(os.environ["AQE_TORCH_BUILD_DIR"])
    faults = {"unchanged_state": harness.unchanged_state}
    faults.update({f: getattr(cell.driver, f) for f in args.faults.split(",")
                   if f and f not in faults})
    rows = []

    def emit(kind: str, seed: int, run, readings: dict, ref: dict, t0: float) -> None:
        row = {"kind": kind, "seed": seed, **bench_run.gaps(cell, run, readings, ref),
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)

    seeds = sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds))
    for seed in seeds:
        run = harness.Run(seed, cell.config, cell.traffic, dev, ROOT)
        t0 = time.perf_counter()
        ref = cell.driver.reference(run)
        ref_s = time.perf_counter() - t0
        if seed in args.seeds:
            t0 = time.perf_counter()
            prog = cell.driver.program(run)
            readings = prog.readings
            prog.free()
            emit("program", seed, run, readings, ref, t0)
            rows[-1]["reference_seconds"] = ref_s
        if seed in args.control_seeds:
            t0 = time.perf_counter()
            emit("control", seed, run, cell.driver.reference(run, control=True), ref, t0)
        if seed in args.fault_seeds:
            for name in [f for f in args.faults.split(",") if f]:
                t0 = time.perf_counter()
                with faults[name]():
                    prog = cell.driver.program(run)
                    readings = prog.readings
                    prog.free()
                emit(name, seed, run, readings, ref, t0)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
