"""The device's idle time within the profiled steps, put down to the
program's layer spans: the host ranges ``aqe::<name>`` that the port opens
at its layers' boundaries (`utils/timing.span`), on the clock of the
profiler's device rows.

The idle time is the gaps between the union of the device operations'
intervals. Each gap is split over time by the innermost span open across
it, by intersection, so that a gap that straddles two layers goes partly to
each. Where the innermost host operation is the profiler's own (its buffer
flushes and requests) the time is dropped from every share, and its
seconds are printed on standard error. The profiler stretches the host's
part of a step, so the readers report the profiled split applied to the
unprofiled step's idle: the window's wall seconds per step less the
profiled busy seconds per step.
"""

from __future__ import annotations

import bisect
import sys
from typing import Optional

from portbench.trace import union

PREFIX = "aqe::"
PROFILER_OWN = ("Buffer Flush", "Activity Buffer Request")


def _minus(segments: list, cuts: list) -> list:
    """The sorted disjoint ``segments`` less the sorted disjoint ``cuts``."""
    out, j = [], 0
    for a, b in segments:
        while j < len(cuts) and cuts[j][1] <= a:
            j += 1
        k = j
        while k < len(cuts) and cuts[k][0] < b:
            if cuts[k][0] > a:
                out.append([a, cuts[k][0]])
            a = max(a, cuts[k][1])
            k += 1
        if a < b:
            out.append([a, b])
    return out


def _merged(intervals) -> list:
    return union([(None, s, e, None) for s, e in intervals])


def profiler_own(host: list) -> list:
    """The sorted disjoint intervals in which the innermost host operation
    (not a span, not a CUDA runtime or driver call, as `Trace.idle_gaps`
    reads them) is one of the profiler's own."""
    own = sorted((h for h in host if h[0] in PROFILER_OWN), key=lambda h: h[1])
    if not own:
        return []
    starts = [h[1] for h in own]
    longest = max(h[2] - h[1] for h in own)
    deeper = [[] for _ in own]
    for name, s, e, depth in host:
        if name.startswith(PREFIX) or name.startswith("cu") or name in PROFILER_OWN:
            continue
        i = bisect.bisect_left(starts, e) - 1
        while i >= 0 and own[i][1] > s - longest:
            if own[i][2] > s and depth > own[i][3]:
                deeper[i].append((max(s, own[i][1]), min(e, own[i][2])))
            i -= 1
    out = []
    for (_, s, e, _), cuts in zip(own, deeper):
        out += _minus([[s, e]], _merged(cuts))
    return _merged(out)


def split(trace) -> tuple:
    """({span name or None: idle seconds}, profiler's own idle seconds) over
    the profiled steps: each idle moment goes to the innermost ``aqe::``
    span open across it (None: no span), by the spans' nesting depth."""
    busy = union(trace.device)
    gaps = [[e, s] for (_, e), (s, _) in zip(busy, busy[1:]) if s > e]
    own = profiler_own(trace.host)
    kept = _minus(gaps, own)
    dropped = sum(b - a for a, b in gaps) - sum(b - a for a, b in kept)
    spans = sorted((h for h in trace.host if h[0].startswith(PREFIX)), key=lambda h: h[1])
    by: dict = {}
    for a, b in kept:
        # the spans open across [a, b), innermost first; each takes what no
        # deeper one took
        cover = sorted(((h[3], max(a, h[1]), min(b, h[2]), h[0]) for h in spans
                        if h[1] < b and h[2] > a), reverse=True)
        rest = [[a, b]]
        for _, s, e, name in cover:
            left = _minus(rest, [[s, e]])
            took = sum(y - x for x, y in rest) - sum(y - x for x, y in left)
            key = name[len(PREFIX):]
            by[key] = by.get(key, 0.0) + took
            rest = left
        by[None] = by.get(None, 0.0) + sum(y - x for x, y in rest)
    return {k: v * 1e-6 for k, v in by.items()}, dropped * 1e-6


_LAST: list = [None, None]


def cached_split(trace) -> tuple:
    """(`split` of ``trace``, the names of the spans it holds), computed
    once for the readers of one run; the profiler's own idle seconds are
    printed on standard error then."""
    if _LAST[0] is not trace:
        names = {h[0][len(PREFIX):] for h in trace.host if h[0].startswith(PREFIX)}
        by, dropped = split(trace) if names else ({}, 0.0)
        _LAST[:] = [trace, (by, names)]
        print(f"idle split: {dropped:.6f} s of idle under the profiler's own work dropped",
              file=sys.stderr, flush=True)
    return _LAST[1]


def unprofiled_idle_s(ctx) -> float:
    """Idle seconds of an unprofiled step: the window's wall seconds per
    step less the profiled busy seconds per step (`device_idle_share`'s
    quantity)."""
    tr, w = ctx.trace, ctx.window
    return w.wall_s / w.steps - tr.busy_s() / tr.steps


def shares(ctx) -> tuple:
    """(each span's share of the profiled steps' idle, None for no span; the
    names of the spans in the trace), the profiler's own idle dropped; None
    without a trace, device rows, window steps, spans or idle."""
    tr = ctx.trace
    if tr is None or not tr.device or not tr.steps or not ctx.window.steps:
        return None
    by, names = cached_split(tr)
    total = sum(by.values())
    if not names or total <= 0:
        return None
    return {k: v / total for k, v in by.items()}, names


def idle_ms(ctx, name: str) -> Optional[float]:
    """Milliseconds of the unprofiled step's idle under the span ``name``,
    or None where the trace holds no such span."""
    got = shares(ctx)
    if got is None or name not in got[1]:
        return None
    return 1e3 * unprofiled_idle_s(ctx) * got[0].get(name, 0.0)


def named_share(ctx) -> Optional[float]:
    """Percent of the profiled steps' idle under a layer's span: any span but
    a whole step's (``*.step``), which holds its layers."""
    got = shares(ctx)
    if got is None:
        return None
    return 100.0 * sum(v for k, v in got[0].items() if k is not None and not k.endswith(".step"))
