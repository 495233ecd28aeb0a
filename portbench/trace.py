"""Reduction of a torch.profiler trace of whole train steps: the device's
operations as intervals, their union (busy time), the idle gaps between
them named by the host operation that ran during each, and the time of
each device operation by name."""

from __future__ import annotations

import collections
import dataclasses


@dataclasses.dataclass
class Trace:
    """Device operations (name, start_us, end_us, is_kernel) and host
    operations (name, start_us, end_us, depth) of the traced window, which
    spans ``window_s`` seconds of wall time and ``steps`` train steps."""

    device: list
    host: list
    window_s: float
    steps: int

    def kernels(self) -> list:
        return [d for d in self.device if d[3]]

    def busy_s(self) -> float:
        return sum(b - a for a, b in union(self.device)) * 1e-6

    def device_s(self, kernel: str) -> float:
        """Seconds of the kernels of the function ``kernel``, in the global
        or an anonymous namespace (the name as the profiler prints it, up to
        its argument list)."""
        want = {kernel, ANON + kernel}
        return sum(e - s for n, s, e, k in self.device if k and function(n) in want) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for name, s, e, _ in self.device:
            by[name] += (e - s) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time between device operations inside the window, summed
        by the innermost host operation (not a CUDA runtime or driver call)
        running at each gap's start."""
        spans = union(self.device)
        host = sorted((h for h in self.host if not h[0].startswith("cu")), key=lambda h: h[1])
        by = collections.Counter()
        active, i = [], 0
        for (_, end), (nxt, _) in zip(spans, spans[1:]):
            while i < len(host) and host[i][1] <= end:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] > end]
            name = max(active, key=lambda h: h[3])[0] if active else "(no host operation)"
            by[name] += (nxt - end) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]


ANON = "(anonymous namespace)::"


def function(name: str) -> str:
    """A kernel's qualified function name without its return type, template
    arguments and argument list: "(anonymous namespace)::rollout_kernel"
    for "(anonymous namespace)::rollout_kernel(float const*, ...)"."""
    name = name.removeprefix("void ").replace(ANON, "\0")
    cut = min([i for i in (name.find("("), name.find("<")) if i >= 0] or [len(name)])
    return name[:cut].replace("\0", ANON)


def union(device: list) -> list:
    """The union of the operations' intervals, as sorted disjoint spans."""
    spans = []
    for _, s, e, _ in sorted(device, key=lambda d: d[1]):
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    return spans


def from_profiler(prof, window_s: float, steps: int) -> Trace:
    """The device and host operations of a finished `torch.profiler.profile`.
    A device operation is any activity on the device (kernels, copies,
    sets), not the ranges the profiler's annotations draw on the device's
    timeline; a kernel is one whose name does not start with Memcpy or
    Memset."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or "#" in e.name:
                continue
            kernel = not (e.name.startswith("Memcpy") or e.name.startswith("Memset"))
            device.append((e.name, s, t, kernel))
        elif e.device_type == DeviceType.CPU and not e.name.startswith("ProfilerStep"):
            depth = 0
            p = e.cpu_parent
            while p is not None:
                depth += 1
                p = p.cpu_parent
            host.append((e.name, s, t, depth))
    return Trace(device, host, window_s, steps)
