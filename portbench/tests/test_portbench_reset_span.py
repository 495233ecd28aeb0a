"""The reader of ``idle_ms.hover_reset`` on a synthetic trace, as
test_portbench_spans.py tests the other ``idle_ms.*`` readers: the reset's
span nests inside ``hover.rollout`` and takes the idle it covers, the
rollout keeps the rest, and a trace without the span (a program that does
not open it) or no trace reads nothing."""

import os

import pytest

from portbench import harness
from portbench.trace import Trace
from portbench.tests.test_portbench_spans import DEVICE, context, reader

# busy [0, 100], [300, 400], [600, 700], [900, 1000] us
HOST = [
    ("aqe::hover.step", 0.0, 850.0, 0),
    ("aqe::hover.rollout", 0.0, 500.0, 1),  # idle 100-300 and 400-500
    ("aqe::hover.reset", 50.0, 250.0, 2),   # idle 100-250 inside it
    ("aqe::hover.update", 500.0, 850.0, 1),  # idle 500-600 and 700-850
]
IDLE_US = {"hover.reset": 150.0, "hover.rollout": 50.0 + 100.0,
           "hover.update": 100.0 + 150.0, None: 50.0}
TOTAL = sum(IDLE_US.values())


def test_the_reset_takes_the_idle_inside_its_span_from_the_rollout():
    ctx = context(Trace(DEVICE, HOST, window_s=1e-3, steps=1))
    idle_ms = 1.0 - 0.4  # the window's 1 ms a step less 400 us busy a profiled step
    got = {n: reader("idle_ms." + n.replace(".", "_")).read(ctx)
           for n in ("hover.reset", "hover.rollout", "hover.update")}
    assert got == pytest.approx({n: idle_ms * IDLE_US[n] / TOTAL for n in got})
    assert sum(got.values()) <= idle_ms


def test_without_the_span_or_a_trace_the_reader_reads_nothing():
    bare = context(Trace(DEVICE, [h for h in HOST if h[0] != "aqe::hover.reset"], 1e-3, 1))
    assert reader("idle_ms.hover_reset").read(bare) is None
    assert reader("idle_ms.hover_rollout").read(bare) == pytest.approx(0.6 * 300.0 / 600.0)
    assert reader("idle_ms.hover_reset").read(context()) is None


def test_the_metric_resolves_to_its_own_file_and_cell():
    entry = next(m for m in harness.benchmark()["per_layer"]
                 if m["name"] == "idle_ms.hover_reset")
    path = harness.metric_reader(entry).__file__
    assert path == os.path.join(harness.ROOT, "portbench", "layer_metrics",
                                "idle_ms.hover_reset.py")
    assert entry["workloads"] == ["hover_defaults_1024x128"]
    assert entry["layer"] == next(m["layer"] for m in harness.benchmark()["per_layer"]
                                  if m["name"] == "idle_ms.hover_rollout")
