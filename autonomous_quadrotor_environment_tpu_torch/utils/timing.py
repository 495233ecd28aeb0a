"""Step timing / profiling helpers.

Counterpart of `utils/timing.py` in the JAX package (the reference's
wall-clock timers, ppo.py:386-390, ppo_forward_time.py:71-77,
quadrotor_cv.py:58,104): one Timer that waits for the card's queued work
before it reads the clock, so that asynchronous launches do not lie, and a
`torch.profiler` trace context.
"""

from __future__ import annotations

import contextlib
import time

import torch


class Timer:
    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def measure(self, *block_on):
        """Time the block, up to the end of the work it queued on the card
        (``block_on``, the JAX version's operands to wait for, is accepted
        and not needed: the whole card is synchronized)."""
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def last(self) -> float:
        return self.times[-1] if self.times else 0.0


@contextlib.contextmanager
def profile_trace(logdir: str):
    """`torch.profiler` trace context: CPU and (when a card is present) CUDA
    activity, written to ``logdir`` as a Chrome trace for TensorBoard or
    chrome://tracing."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof
