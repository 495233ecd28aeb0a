"""The port's layer spans (`utils/timing.span`) and the CUDA-graph capture
counter (`utils/graphs.CAPTURES`): with no profiler a span is the shared
null context; under `torch.profiler` each train step records its
``aqe::`` spans nested in step order; a capture is counted and timed under
its own span. Tiny shapes on the CPU, through the kernels' plain
versions."""

import contextlib
import dataclasses
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from autonomous_quadrotor_environment_tpu_torch.agents import ppo
from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
from autonomous_quadrotor_environment_tpu_torch.config import EnvConfig, PPOConfig, TrainConfig
from autonomous_quadrotor_environment_tpu_torch.landing import ppo as lppo
from autonomous_quadrotor_environment_tpu_torch.landing.env import LandingConfigs
from autonomous_quadrotor_environment_tpu_torch.utils import graphs, timing
from torch_parity import one_torch_thread  # noqa: F401 (the fixture below)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def traced(fn, path) -> list:
    """(name, depth among the spans) of every ``aqe::`` range that ``fn``
    opens under `torch.profiler`, in start order, read from the profiler's
    Chrome trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    found = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(timing.SPAN_PREFIX):])
                   for e in events if e.get("name", "").startswith(timing.SPAN_PREFIX))
    return [(name, sum(a <= s and t <= b for a, b, _ in found) - 1) for s, t, name in found]


def test_a_span_without_a_profiler_is_the_shared_null_context(tmp_path):
    first, second = timing.span("hover.step"), timing.span("landing.update")
    assert first is second and isinstance(first, contextlib.nullcontext)
    with first:
        pass
    inside = []

    def opened():
        inside.append(timing.span("hover.step"))
        with inside[0]:
            torch.ones(2).sum()

    assert traced(opened, tmp_path / "trace.json") == [("hover.step", 0)]
    assert inside[0] is not first and timing.span("hover.step") is first


def hover_step(fused: bool):
    env_cfg = EnvConfig()
    if fused:
        ppo_cfg = PPOConfig(k_epochs=1, minibatch_size=64, shuffle_block=8, fused_update=True)
        train_cfg = TrainConfig(num_envs=16, rollout_steps=16, network_size=16,
                                fused_rollout=True, fused_pool=2)
    else:
        ppo_cfg = PPOConfig(k_epochs=1)
        train_cfg = TrainConfig(num_envs=4, rollout_steps=4, network_size=16)
    model, opt, state = ppo.ppo_init(0, env_cfg, ppo_cfg, train_cfg, device="cpu")
    step = ppo.make_train_step(model, opt, env_cfg, ppo_cfg, train_cfg)
    assert ppo.train_branch(model, env_cfg, ppo_cfg, train_cfg) == (
        "fused_t" if fused else "rowmajor")
    return lambda: step(state)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "rowmajor"])
def test_a_hover_step_records_its_layer_spans(fused, tmp_path):
    step = hover_step(fused)
    layers = [("hover.inputs", 1)] * fused + [("hover.rollout", 1)] + [
        ("hover.reset", 2)] * (not fused) + [("hover.update", 1)]
    assert traced(step, tmp_path / "trace.json") == [("hover.step", 0)] + layers


def test_a_landing_step_records_its_layer_spans(tmp_path):
    cfgs = LandingConfigs.default(training=True)
    cfg = dataclasses.replace(PPOConfig.landing_variant(), k_epochs=1, minibatch_size=0)
    ctrl = ActorCritic(hidden=16).eval()
    model, opt, state = lppo.landing_ppo_init(0, cfgs, cfg, 2, ctrl, device="cpu")
    step = lppo.make_landing_train_step(model, opt, cfgs, cfg, ctrl, 2, reset_pool=1)
    assert traced(lambda: step(state), tmp_path / "trace.json") == [
        ("landing.step", 0), ("landing.rollout", 1), ("landing.update", 1)]


class _Stub:
    """Stands in for every CUDA stream, graph and pool a capture touches."""

    def __init__(self, *args, **kwargs):
        pass

    def wait_stream(self, other):
        pass

    def replay(self):
        pass


def test_a_capture_is_counted_timed_and_spanned(monkeypatch, tmp_path):
    synced = []
    for name, value in (("Stream", _Stub), ("CUDAGraph", _Stub),
                        ("current_stream", lambda device=None: _Stub()),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("graph", lambda g, pool=None, stream=None: contextlib.nullcontext()),
                        ("graph_pool_handle", _Stub),
                        ("synchronize", lambda device=None: synced.append(device))):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(graphs.Graph, "_pool", None)
    monkeypatch.setattr(graphs, "CAPTURES", graphs.Captures())
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(0.01)
        return x * 2

    x = torch.arange(3.0)
    g = graphs.Graph(fn, (x,))
    assert (graphs.CAPTURES.count, len(calls), synced) == (1, 3, [x.device])
    assert 0.03 <= graphs.CAPTURES.seconds < 5.0
    assert torch.equal(g(x + 1), 2 * x)  # the stub replays nothing: the captured output
    assert traced(lambda: graphs.Graph(fn, (x,)), tmp_path / "trace.json") == [
        ("graphs.capture", 0)]
    assert graphs.CAPTURES.count == 2
