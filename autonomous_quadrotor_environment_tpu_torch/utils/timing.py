"""Step timing and the port's layer spans.

Counterpart of `utils/timing.py` in the JAX package (the reference's
wall-clock timers, ppo.py:386-390, ppo_forward_time.py:71-77,
quadrotor_cv.py:58,104): one Timer that waits for the card's queued work
before it reads the clock, so that asynchronous launches do not lie, and
`span`, a named range at a layer boundary of the train steps.

A span costs one flag check while no `torch.profiler` records. Under a
profiler it is a host range named ``aqe::<name>`` in the profiler's own
trace, on the clock of the card's operations and nested by the host's
calls, so that an idle stretch of the card can be put down to the layer
the host was in. To see them, run any app, or ``portbench/run.py --trace
1``, under `torch.profiler.profile` and read its events or
`export_chrome_trace`.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.autograd.profiler as _profiler

SPAN_PREFIX = "aqe::"
_OFF = contextlib.nullcontext()


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


def span(name: str):
    """A context manager around one layer of a step: a shared null context
    while no profiler records, else `record_function` of ``"aqe::" +
    name``. Never open one inside a function that `utils.graphs.run` or
    `scan` captures: it would run at the capture alone, not at the
    replays; open it around the call."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(SPAN_PREFIX + name)
