"""Step loops as CUDA graphs: capture a function of tensors once, replay it.

A step of the env and its controller is a few hundred small kernels, so an
eager loop on the card is bound by the host's launches. `run` captures such
a function into one CUDA graph per call site, shapes and device, and
replays it; `scan` runs a step body over many steps as replays of chunks of
steps. Both run the function eagerly on the CPU.

A capture copies the inputs into static buffers, runs the function twice
eagerly on a side stream (cuBLAS and the cached device constants settle),
then captures it into the memory pool that every graph shares. Each call
copies its inputs into the static buffers, replays, and clones the outputs,
so nothing the caller keeps aliases a buffer that the next replay, of this
graph or another one in the pool, overwrites. Parameters that the function
reads in place (a model's weights, which an optimizer updates in place) are
named at capture; a call raises if one of them no longer lives where it was
captured. Launches of the counted kernels made during the capture are taken
back from their counters and added on every replay. `CAPTURES` counts the
captures and the host seconds they took, each up to a sync of the card,
under the span ``graphs.capture`` (`utils.timing.span`); `REPLAYS` counts
the replays of each key of `run`, over its shapes. A failed capture
raises: there is no eager fall back on the card. `eager()` runs every call
eagerly for as long as it is open, to compare the two.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from .timing import span


def leaves(tree) -> list:
    """The tensors of a tree of tensors, dataclasses, NamedTuples, tuples,
    lists, dicts and Nones, in field order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    return [leaf for node in tree for leaf in leaves(node)]


def rebuild(tree, new):
    """``tree`` with its tensors replaced, in `leaves` order, from the
    iterator ``new``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return next(new)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: rebuild(getattr(tree, f.name), new)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: rebuild(v, new) for k, v in tree.items()}
    nodes = [rebuild(node, new) for node in tree]
    return type(tree)(*nodes) if hasattr(tree, "_fields") else type(tree)(nodes)


def tree_map(fn: Callable, tree):
    """``tree`` with each tensor ``x`` replaced by ``fn(x)``."""
    return rebuild(tree, iter([fn(x) for x in leaves(tree)]))


def _counted() -> tuple:
    """The kernel wrappers whose ``launches`` count their launches."""
    from ..ops import ppo_fused, ppo_fused_t, render_kernel, rollout_fused

    return (rollout_fused.fused_rollout, ppo_fused_t.fused_ppo_grad_t,
            ppo_fused.fused_ppo_grad, ppo_fused.fused_ppo_grad_adam,
            render_kernel.render_nadir_batch)


def counted_launches() -> dict:
    """Each counted kernel's launches in this process so far, by its
    wrapper's name."""
    return {k.__name__: k.launches for k in _counted()}


@dataclasses.dataclass
class Captures:
    """The graphs captured in this process so far, and the host seconds
    their captures took: the inputs' copies, the warm-up runs and the
    capture, up to a sync of the card."""

    count: int = 0
    seconds: float = 0.0


CAPTURES = Captures()
# The replays in this process so far, by the key given to `run` (`scan`'s
# keys carry the chunk's length and phase).
REPLAYS: collections.Counter = collections.Counter()


class Graph:
    """``fn(*args)`` as one CUDA graph, for inputs of the shapes, dtypes and
    device of ``args`` (trees of tensors); ``params`` are tensors that ``fn``
    reads in place. It records no autograd history: call it under
    `torch.no_grad`, as `run` does."""

    _pool = None

    def __init__(self, fn: Callable, args: tuple, params=()):
        t0 = time.perf_counter()
        with span("graphs.capture"):
            self._capture(fn, args, params)
        CAPTURES.count += 1
        CAPTURES.seconds += time.perf_counter() - t0

    def _capture(self, fn: Callable, args: tuple, params) -> None:
        self.fn = fn
        self.params = list(params)
        self.ptrs = [p.data_ptr() for p in self.params]
        self.inputs = [x.clone() for x in leaves(args)]
        self.static_args = rebuild(args, iter(self.inputs))
        device = self.inputs[0].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                fn(*self.static_args)
        torch.cuda.current_stream(device).wait_stream(side)
        if Graph._pool is None:
            Graph._pool = torch.cuda.graph_pool_handle()
        self.graph = torch.cuda.CUDAGraph()
        counted = _counted()
        before = [k.launches for k in counted]
        with torch.cuda.graph(self.graph, pool=Graph._pool, stream=side):
            self.out_tree = fn(*self.static_args)
        self.outputs = leaves(self.out_tree)
        self.captured = [(k, k.launches - b) for k, b in zip(counted, before)]
        for k, b in zip(counted, before):
            k.launches = b
        torch.cuda.synchronize(device)

    def __call__(self, *args):
        for p, ptr in zip(self.params, self.ptrs):
            if p.data_ptr() != ptr:
                raise RuntimeError(
                    "a parameter this CUDA graph reads in place was replaced by another "
                    "tensor since the capture; update parameters in place")
        new = leaves(args)
        if len(new) != len(self.inputs):
            raise ValueError(f"the graph takes {len(self.inputs)} tensors, not {len(new)}")
        for dst, src in zip(self.inputs, new):
            dst.copy_(src)
        self.graph.replay()
        for k, n in self.captured:
            k.launches += n
        return rebuild(self.out_tree, iter([x.clone() for x in self.outputs]))


_GRAPHS: dict = {}
_EAGER = [False]


@contextlib.contextmanager
def eager():
    """Run every `run` and `scan` eagerly, on the card too, while open."""
    _EAGER[0] = True
    try:
        yield
    finally:
        _EAGER[0] = False


def run(key, fn: Callable, args: tuple, params=()):
    """``fn(*args)``: eagerly on the CPU (and under `eager`); on the card,
    the replay of the graph of ``key`` at these inputs' shapes, dtypes and
    device, captured on first use. ``key`` names what ``fn`` computes
    besides its inputs (a model's id, a config), so the graph must hold
    what it names alive (as ``fn``'s closure does) for the id not to be
    reused."""
    ins = leaves(args)
    if _EAGER[0] or ins[0].device.type != "cuda":
        return fn(*args)
    full = (key, ins[0].device, tuple((tuple(x.shape), x.dtype) for x in ins))
    with torch.no_grad():
        graph = _GRAPHS.get(full)
        if graph is None:
            graph = _GRAPHS[full] = Graph(fn, args, params)
        out = graph(*args)
    REPLAYS[key] += 1
    return out


def _stack(ys: list):
    if ys[0] is None:
        return None
    return rebuild(ys[0], iter([torch.stack(col) for col in zip(*map(leaves, ys))]))


def scan(key, body: Callable, carry, length: int, *, xs=None, consts=None,
         chunk: Optional[int] = None, params=(),
         stop: Optional[Callable[[Any], bool]] = None, period: Optional[int] = None,
         start: int = 0):
    """``for i in range(start, start + length): carry, y = body(carry, i,
    x_i, consts)``, returning the final carry and the ``y`` stacked along a
    new first axis.

    ``i`` is a 0-d int64 tensor on the carry's device. ``xs`` is a tree
    whose first axis is the step counted from ``start``, or a function
    ``xs(i0, n)`` that draws the inputs of steps i0..i0+n-1 eagerly (in the
    order an eager loop would draw them); ``consts`` are inputs that every
    step reads. The steps run in chunks of ``chunk`` (all of them when
    None), each chunk one `run` of ``key`` at its length; before each chunk
    but the first, ``stop(carry)`` may end the loop early (the stacked ``y``
    then covers the steps run).

    With ``period``, each step also gets its phase ``i % period`` as a
    Python int, ``body(carry, i, x_i, consts, phase)``, so that work due
    only on some steps is left out of the others' graph nodes: a chunk's
    graph is keyed by its first step's phase as well (one graph when
    ``period`` divides ``chunk``)."""
    chunk = chunk or length
    device = leaves(carry)[0].device

    def steps(n, p0):
        def fn(carry, i0, x, consts):
            ys = []
            for k in range(n):
                xk = None if x is None else tree_map(lambda a: a[k], x)
                if period is None:
                    carry, y = body(carry, i0 + k, xk, consts)
                else:
                    carry, y = body(carry, i0 + k, xk, consts, (p0 + k) % period)
                ys.append(y)
            return carry, _stack(ys)
        return fn

    outs, i, end = [], start, start + length
    while i < end:
        if i > start and stop is not None and stop(carry):
            break
        n = min(chunk, end - i)
        if xs is None:
            x = None
        elif callable(xs):
            x = xs(i, n)
        else:
            x = tree_map(lambda a: a[i - start:i - start + n], xs)
        i0 = torch.full((), i, dtype=torch.int64, device=device)
        p0 = None if period is None else i % period
        carry, ys = run((key, n) if period is None else (key, n, p0), steps(n, p0),
                        (carry, i0, x, consts), params)
        outs.append(ys)
        i += n
    if not outs or outs[0] is None:
        return carry, None
    return carry, rebuild(outs[0], iter([torch.cat(col) for col in zip(*map(leaves, outs))]))
