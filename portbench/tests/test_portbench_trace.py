"""The trace reduction on a synthetic trace: busy time as the union of
device intervals, idle gaps named by the innermost host operation, kernel
times by qualified function name; the idle share's step length taken from
the unprofiled window."""

import pytest

from portbench import harness
from portbench.harness import Context, Window
from portbench.trace import Trace, function, union

DEVICE = [
    ("(anonymous namespace)::rollout_kernel(float const*)", 0.0, 100.0, True),
    ("void at::native::reduce_kernel<512, 1>(int)", 50.0, 150.0, True),   # overlaps
    ("(anonymous namespace)::reduce_kernel(float const*, int)", 300.0, 400.0, True),
    ("Memcpy HtoD (Pageable -> Device)", 500.0, 520.0, False),
]
HOST = [
    ("aten::randperm", 140.0, 320.0, 0),
    ("aten::copy_", 160.0, 200.0, 1),        # starts after the gap's start
    ("cudaLaunchKernel", 145.0, 152.0, 1),   # runtime calls name no gap
    ("aten::mul", 399.0, 450.0, 0),
]


def test_union_and_busy():
    assert union(DEVICE) == [[0.0, 150.0], [300.0, 400.0], [500.0, 520.0]]
    tr = Trace(DEVICE, HOST, window_s=1e-3, steps=2)
    assert tr.busy_s() == pytest.approx(270e-6)
    assert len(tr.kernels()) == 3


def test_idle_share_takes_the_step_from_the_unprofiled_window():
    # 135 us busy a profiled step; the profiled steps span 1 ms, the
    # unprofiled ones 0.5 ms each: idle 1 - 135 / 500, not 1 - 135 / 500 * 2
    tr = Trace(DEVICE, HOST, window_s=1e-3, steps=2)
    ctx = Context(config={}, traffic={}, window=Window(steps=4, wall_s=2e-3, step_ms=[0.5] * 4),
                  trace=tr, setup_s=1.0, work_per_step=1.0)
    for name in ("device_idle_share.hover", "device_idle_share.landing"):
        reader = harness.metric_reader({"name": name, "layer": "device"})
        assert reader.read(ctx) == pytest.approx(100.0 * (1 - 135e-6 / 0.5e-3))
    assert harness.metric_reader({"name": "kernels_per_update.landing", "layer": "x"}).read(
        ctx) == 1.5
    host_tail = harness.metric_reader({"name": "train_step_ms_p90.host", "layer": "x"})
    assert host_tail.read(ctx) == pytest.approx(0.5)


def test_device_busy_is_per_profiled_step_and_silent_without_a_trace():
    tr = Trace(DEVICE, HOST, window_s=1e-3, steps=2)
    window = Window(steps=4, wall_s=2e-3, step_ms=[0.5] * 4)
    reader = harness.metric_reader({"name": "device_busy_ms.landing", "layer": "device"})
    ctx = Context(config={}, traffic={}, window=window, trace=tr, setup_s=1.0, work_per_step=1.0)
    assert reader.read(ctx) == pytest.approx(0.135)
    ctx.trace = None
    assert reader.read(ctx) is None


def test_gaps_are_named_by_the_innermost_host_operation():
    tr = Trace(DEVICE, HOST, window_s=1e-3, steps=2)
    assert dict(tr.idle_gaps()) == pytest.approx({"aten::randperm": 150e-6, "aten::mul": 100e-6})


def test_kernel_time_by_qualified_function():
    tr = Trace(DEVICE, HOST, window_s=1e-3, steps=2)
    assert tr.device_s("rollout_kernel") == pytest.approx(100e-6)
    assert tr.device_s("reduce_kernel") == pytest.approx(100e-6)  # not at::native's
    assert function("void at::native::reduce_kernel<512>(x)") == "at::native::reduce_kernel"
    assert tr.top_ops(1)[0][0].startswith("(anonymous namespace)::rollout_kernel")
