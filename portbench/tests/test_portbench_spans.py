"""The idle split by the program's layer spans (`portbench/spans.py`) on a
synthetic trace: a gap is split over the spans open across it by
intersection, the profiler's own work is dropped from both sides, the
profiled split is applied to the unprofiled step's idle; and the new
readers resolve to their own files and read nothing without a trace."""

import os

import pytest

from portbench import harness, spans
from portbench.harness import Context, Window
from portbench.trace import Trace

# busy [0, 100], [300, 400], [600, 700], [900, 1000] us; idle [100, 300],
# [400, 600], [700, 900]
DEVICE = [("k", 0.0, 100.0, True), ("k", 300.0, 400.0, True), ("k", 600.0, 700.0, True),
          ("Memcpy HtoD", 900.0, 1000.0, False)]
HOST = [
    ("aqe::hover.step", 0.0, 850.0, 0),
    ("aqe::hover.inputs", 0.0, 200.0, 1),     # idle 100-200
    ("aqe::hover.rollout", 200.0, 350.0, 1),  # idle 200-300: the first gap straddles two spans
    ("aqe::hover.update", 350.0, 750.0, 1),   # idle 400-600 less the flush, and 700-750
    ("Buffer Flush", 450.0, 500.0, 2),        # the profiler's own, 40 us innermost:
    ("aten::copy_", 480.0, 490.0, 3),         # a deeper operation keeps 480-490
    ("cudaLaunchKernel", 455.0, 460.0, 3),    # runtime calls do not
    ("Activity Buffer Request", 410.0, 420.0, 0),  # under aten::mul, deeper: kept
    ("aten::mul", 405.0, 425.0, 2),
    # 750-850 under the step's span alone, 850-900 under none
]
IDLE_US = {"hover.inputs": 100.0, "hover.rollout": 100.0, "hover.update": 160.0 + 50.0,
           "hover.step": 100.0, None: 50.0}
TOTAL = sum(IDLE_US.values())  # 560 us kept, 40 dropped
NEW = ("idle_ms.hover_inputs", "idle_ms.hover_rollout", "idle_ms.hover_update",
       "idle_ms.landing_rollout", "idle_ms.landing_update", "idle_named_share.hover",
       "idle_named_share.landing", "capture_s.hover", "capture_s.landing")


def context(trace=None) -> Context:
    # the unprofiled window: 4 steps of 1 ms; profiled: 1 step, 400 us busy
    return Context(config={}, traffic={}, window=Window(steps=4, wall_s=4e-3, step_ms=[1.0] * 4),
                   trace=trace, setup_s=1.0, work_per_step=1.0)


def reader(name):
    return harness.metric_reader({"name": name, "layer": "x"})


def test_a_gap_is_split_by_intersection_and_the_profilers_own_work_dropped():
    by, dropped = spans.split(Trace(DEVICE, HOST, window_s=1e-3, steps=1))
    assert by == pytest.approx({k: v * 1e-6 for k, v in IDLE_US.items()})
    assert dropped == pytest.approx(40e-6)
    assert spans.profiler_own(HOST) == [[450.0, 480.0], [490.0, 500.0]]


def test_the_split_is_applied_to_the_unprofiled_steps_idle(capsys):
    ctx = context(Trace(DEVICE, HOST, window_s=1e-3, steps=1))
    idle_ms = 1.0 - 0.4  # the window's 1 ms a step less 400 us busy a profiled step
    got = {n: reader(n).read(ctx) for n in NEW[:3]}
    assert got == pytest.approx({
        "idle_ms.hover_inputs": idle_ms * 100.0 / TOTAL,
        "idle_ms.hover_rollout": idle_ms * 100.0 / TOTAL,
        "idle_ms.hover_update": idle_ms * 210.0 / TOTAL})
    assert sum(got.values()) <= idle_ms
    assert "0.000040 s of idle under the profiler's own work dropped" in capsys.readouterr().err
    # spans the trace does not hold read nothing
    assert reader("idle_ms.landing_update").read(ctx) is None


def test_the_named_share_counts_layer_spans_only():
    ctx = context(Trace(DEVICE, HOST, window_s=1e-3, steps=1))
    want = 100.0 * (100.0 + 100.0 + 210.0) / TOTAL
    for name in ("idle_named_share.hover", "idle_named_share.landing"):
        assert reader(name).read(ctx) == pytest.approx(want)
    # a trace without spans (a program that opens none) reads nothing
    bare = context(Trace(DEVICE, [h for h in HOST if not h[0].startswith("aqe::")], 1e-3, 1))
    assert all(reader(n).read(bare) is None for n in NEW)


def test_every_new_reader_reads_nothing_without_a_trace():
    assert [reader(n).read(context()) for n in NEW] == [None] * len(NEW)


def test_capture_seconds_are_the_programs_counter(monkeypatch):
    from autonomous_quadrotor_environment_tpu_torch.utils import graphs

    ctx = context(Trace(DEVICE, HOST, window_s=1e-3, steps=1))
    monkeypatch.setattr(graphs, "CAPTURES", graphs.Captures(count=2, seconds=7.5))
    assert reader("capture_s.hover").read(ctx) == 7.5
    assert reader("capture_s.landing").read(ctx) == 7.5
    monkeypatch.setattr(graphs, "CAPTURES", graphs.Captures())
    assert reader("capture_s.hover").read(ctx) is None


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_resolves_to_its_own_file(name):
    entry = next(m for m in harness.benchmark()["per_layer"] if m["name"] == name)
    stem = name if name.startswith("idle_ms.") else name.split(".")[0]
    path = harness.metric_reader(entry).__file__
    assert os.path.basename(path) == stem + ".py"
    assert os.path.dirname(path) == os.path.join(harness.ROOT, "portbench", "layer_metrics")
