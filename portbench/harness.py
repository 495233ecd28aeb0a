"""The benchmark's machinery: it finds a cell's files by name, runs the
program's set-up and measured window, reads the trace, runs the per-layer
readers and the reference, and builds the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name `BENCHMARK.json`
gives it:

* ``portbench/configs/<config>.json``: the configuration as it is run;
* ``portbench/workloads/<traffic>.json``: the traffic mix's parameters,
  the driver that runs it and the limits of its comparison;
* ``portbench/drivers/<driver>.py``: the general generator of one kind of
  traffic: ``program(run)`` (the program's train step after its set-up
  steps), ``reference(run, control)``, the fault ``half_batch()`` and,
  optionally, ``gaps(run, readings, ref)``, its own comparison (the
  default is `compare.gaps`); the numbers judged are those the traffic
  file gives limits for;
* ``portbench/end_to_end/<metric>.py`` and
  ``portbench/layer_metrics/<metric>.py``: a reader, ``read(ctx)``, that
  returns the metric's value, or None when it finds nothing to read. A
  metric with no file of its own name is read by the reader of its name
  before the first dot (``device_idle_share`` reads
  ``device_idle_share.hover`` and ``device_idle_share.landing``), in
  either folder.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import time
from typing import Any, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Modules that may not be loaded in a run: JAX and the JAX package. Names
# are compared by their top-level part, whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "autonomous_quadrotor_environment_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def stream(seed: int, *tags: int) -> int:
    """A 63-bit generator seed for the stream ``tags`` of run ``seed``."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), *tags]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str):
    """The module at ``path``, loaded under ``name`` (metric files may carry
    dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell and everything found for it by name."""

    name: str
    entry: dict        # its `workloads` entry
    config: dict       # portbench/configs/<config>.json
    traffic: dict      # portbench/workloads/<traffic>.json
    end_to_end: list   # the `end_to_end` entries it reports
    per_layer: list    # the `per_layer` entries it reports
    driver: Any        # portbench/drivers/<driver>.py


def _reported(metrics: list, cell: str, e2e_names: set) -> list:
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif e2e_names is None or m.get("moves") in e2e_names:
            out.append(m)
    return out


def find_cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    entry = entries[0]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[entry["config"]]["file"]))
    here = os.path.join(root, "portbench")
    traffic = _json(os.path.join(here, "workloads", entry["traffic"] + ".json"))
    e2e = _reported(bench["end_to_end"], name, None)
    per_layer = _reported(bench["per_layer"], name, {m["name"] for m in e2e})
    driver = load_module(os.path.join(here, "drivers", traffic["driver"] + ".py"),
                         "portbench_driver_" + traffic["driver"])
    return Cell(name, entry, config, traffic, e2e, per_layer, driver)


def metric_reader(metric: dict, root: str = ROOT):
    """The reader of a `BENCHMARK.json` metric entry: a per-layer metric's
    ``layer_metrics/<name>.py``, an end-to-end metric's
    ``end_to_end/<name>.py``; without such a file, the reader of the name
    before its first dot, in its own folder and then in the other."""
    own = "layer_metrics" if "layer" in metric else "end_to_end"
    other = "end_to_end" if own == "layer_metrics" else "layer_metrics"
    name, base = metric["name"], metric["name"].split(".")[0]
    for folder, stem in ((own, name), (own, base), (other, base)):
        path = os.path.join(root, "portbench", folder, stem + ".py")
        if os.path.exists(path):
            return load_module(path, f"portbench_{folder}_" + stem.replace(".", "_"))
    raise FileNotFoundError(f"no reader for the metric {name!r} in portbench/{own}/")


@dataclasses.dataclass
class Context:
    """What a metric's reader reads: the cell's configuration and traffic,
    the measured window, the trace of the profiled steps after it (None
    without --trace 1), the set-up seconds and the work of one train step."""

    config: dict
    traffic: dict
    window: Any
    trace: Any
    setup_s: float
    work_per_step: float


@dataclasses.dataclass
class Window:
    """What the measured window saw."""

    steps: int            # train steps completed
    wall_s: float         # from the first enqueue to the sync after the last step
    step_ms: list         # each step's time by CUDA events at its boundaries


def measure(step, seconds: float, sync, event) -> Window:
    """Enqueue train steps for ``seconds`` of host time, each between two
    CUDA events recorded on the stream, with no host synchronization
    between steps; then synchronize. ``event()`` makes a timing event."""
    sync()
    marks = [event()]
    t0 = time.perf_counter()
    marks[0].record()
    while time.perf_counter() - t0 < seconds:
        step()
        marks.append(event())
        marks[-1].record()
    sync()
    wall = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return Window(len(ms), wall, ms)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


@dataclasses.dataclass
class Run:
    """One run of a cell: its seed, configuration and traffic, and the device."""

    seed: int
    config: dict
    traffic: dict
    device: Any
    root: str = ROOT


def generator(run: Run, tag: int):
    """A generator on the run's device, seeded from the run's seed and
    ``tag``: 0 makes the weights, 1 the first envs, 2 is the train state's."""
    import torch

    return torch.Generator(device=run.device).manual_seed(stream(run.seed, tag))


def make_leaves(spec: list, seed: int, device) -> dict:
    """The leaves of ``spec`` ((name, shape, kind, scale) each) from the
    seed, on the device in one draw: "normal" leaves are standard normals
    times scale, "zeros" zero, "fill" filled with scale."""
    import torch

    g = torch.Generator(device=device).manual_seed(stream(seed, 0))
    size = lambda shape: int(np.prod(shape))
    n = sum(size(s) for _, s, kind, _ in spec if kind == "normal")
    flat = torch.randn(n, generator=g, device=device)
    out, i = {}, 0
    for name, shape, kind, scale in spec:
        if kind == "normal":
            out[name] = flat[i:i + size(shape)].reshape(shape).mul(scale)
            i += size(shape)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.full(shape, float(scale), device=device)
    return out


def load_leaves(model, leaves: dict) -> None:
    """Copy ``leaves`` into the model's parameters, which must carry the same
    names, in the same order, with the same shapes."""
    import torch

    named = list(model.named_parameters())
    if [n for n, _ in named] != list(leaves):
        raise ValueError(f"the model's parameters {[n for n, _ in named]} are not {list(leaves)}")
    with torch.no_grad():
        for (name, p) in named:
            p.copy_(leaves[name].reshape(p.shape))


def setup_steps(prog, model, opt, n: int) -> dict:
    """``n`` train steps through the program's own call, which also warm it
    up, and their readings: each step's loss, each leaf's first gradient as
    the optimizer got it (Adam's first moment after its first step over
    1 - beta1; its norm, and the whole tensor on the host as
    ``first_grad_t``), each leaf's change from the start over the ``n``
    steps, and the envs' physics states the first step handed on
    (`Program.env_x`)."""
    import torch

    names = [k for k, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    first = []

    def hook(optimizer, args, kwargs):
        if not first:
            b1 = optimizer.param_groups[0]["betas"][0]
            first.extend(optimizer.state[p]["exp_avg"].float().div(1.0 - b1)
                         for p in params)

    handle = opt.register_step_post_hook(hook)
    try:
        losses = [prog.step()["loss"]]
        state = prog.env_x().detach().float().cpu()
        losses += [prog.step()["loss"] for _ in range(n - 1)]
    finally:
        handle.remove()
    if not first:
        raise RuntimeError("the optimizer took no step in the set-up steps")
    return {
        "names": names,
        "losses": [float(x) for x in losses],
        "first_grad": [float(torch.linalg.vector_norm(g)) for g in first],
        "first_grad_t": [g.cpu() for g in first],
        "change": [float(torch.linalg.vector_norm(p.detach().float() - prog.start[k].float()))
                   for k, p in zip(names, params)],
        "state": state,
    }


@contextlib.contextmanager
def first_call(owner, name: str, take):
    """While open, ``owner.<name>`` is wrapped: its first call's arguments
    also go to ``take(*args, **kwargs)``, whose result is appended to the
    list this yields. Later calls pass straight through."""
    fn = getattr(owner, name)
    got = []

    def wrapped(*args, **kwargs):
        if not got:
            got.append(take(*args, **kwargs))
        return fn(*args, **kwargs)

    with patched(owner, **{name: wrapped}):
        yield got


@contextlib.contextmanager
def patched(owner, **attrs):
    """``owner``'s attributes replaced by ``attrs`` while open."""
    saved = {k: getattr(owner, k) for k in attrs}
    for k, v in attrs.items():
        setattr(owner, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(owner, k, v)


def unchanged_state():
    """A fault planted under the program: every Adam step runs (its moments
    and hooks too) and then puts the parameters back as they were, so each
    train step returns the model unchanged."""
    import torch

    step = torch.optim.Adam.step

    def kept(self, *args, **kwargs):
        before = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        out = step(self, *args, **kwargs)
        with torch.no_grad():
            for p, b in zip([p for g in self.param_groups for p in g["params"]], before):
                p.copy_(b)
        return out

    return patched(torch.optim.Adam, step=kept)
