"""Run one cell of the port's benchmark once, on the card, and print its
result as one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run makes its weights and envs from the seed, builds the program's train
step, takes the set-up steps (which warm up every shape the cell uses and
give the readings the reference is compared with), then measures for
``--seconds``. With ``--trace 1`` the profiler follows a few more whole
steps and the metrics are the cell's per-layer ones; otherwise they are its
end-to-end ones. After the window the program is freed and the plain
reference follows the set-up steps; ``correct`` says whether each compared
number is within its limit. The numbers compared are printed with their
limits as the last lines on standard error and under ``checks`` in the
result line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def caches(root: str) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so that only a checkout's first run builds."""
    base = os.path.join(root, ".portbench_cache")
    os.environ["AQE_TORCH_BUILD_DIR"] = os.path.join(base, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["USE_FLAX"] = "0"
    os.makedirs(os.environ["AQE_TORCH_BUILD_DIR"], exist_ok=True)


class HostEvent:
    """A timing event on the host clock, where no card is used (tests)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def profile_steps(prog, n: int, sync):
    """``n`` whole train steps under torch.profiler; their trace."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    sync()
    prof.start()
    t0 = time.perf_counter()
    for _ in range(n):
        prog.step()
    sync()
    window = time.perf_counter() - t0
    prof.stop()
    return trace.from_profiler(prof, window, n)


def gaps(cell, run, readings: dict, ref: dict) -> dict:
    """The numbers compared: the cell's driver's own comparison where it
    has one, else `compare.gaps`."""
    from portbench import compare

    own = getattr(cell.driver, "gaps", None)
    return own(run, readings, ref) if own is not None else compare.gaps(readings, ref)


def execute(args, device, t_start: float = T_START, root: str = ROOT) -> tuple:
    """Run the cell on ``device`` (the card, or the CPU in tests). Returns
    (result line, lines for standard error, exit code)."""
    import torch

    from portbench import compare, harness

    cell = harness.find_cell(args.workload, root)
    cuda = torch.device(device).type == "cuda"
    torch.set_num_threads(2)
    # The configurations state float32 or bf16 products: no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    event = (lambda: torch.cuda.Event(enable_timing=True)) if cuda else HostEvent
    if cuda:
        from autonomous_quadrotor_environment_tpu_torch.utils.cache import (
            enable_compilation_cache)

        enable_compilation_cache(os.environ["AQE_TORCH_BUILD_DIR"])
    run = harness.Run(args.seed, cell.config, cell.traffic, torch.device(device), root)
    prog = cell.driver.program(run)
    sync()
    setup_s = time.perf_counter() - t_start
    window = harness.measure(prog.step, args.seconds, sync, event)
    traced = profile_steps(prog, cell.traffic["profile_steps"], sync) if args.trace else None
    sync()
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    if traced is not None:
        device_info.update(busy_s=traced.busy_s(), window_s=traced.window_s)
    readings, work = prog.readings, prog.work_per_step
    prog.free()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ctx = harness.Context(config=cell.config, traffic=cell.traffic, window=window,
                          trace=traced, setup_s=setup_s, work_per_step=work)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = harness.metric_reader(m, root).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ref = cell.driver.reference(run)
    correct, checks = compare.judge(gaps(cell, run, readings, ref), cell.traffic["limits"])
    breakdown = None
    if traced is not None:
        breakdown = {"device_ops": traced.top_ops(), "idle_gaps": traced.idle_gaps()}
    loaded = harness.forbidden_modules()
    if loaded:
        return None, [f"forbidden modules loaded: {', '.join(loaded)}"], 3
    line = harness.result_line(correct, window.steps, 0, metrics, device_info, checks, breakdown)
    return line, compare.check_lines(checks), 0


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    caches(ROOT)
    import torch

    from portbench import harness

    try:
        chips = harness.find_cell(args.workload, ROOT).entry["chips"]
    except (OSError, KeyError) as err:
        print(f"cannot read the cell {args.workload!r}: {err}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, lines, code = execute(args, "cuda")
    for text in lines:
        print(text, file=sys.stderr, flush=True)
    if line is not None:
        print(line, flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
