"""A traced window: the profiler's events reduced to what the metrics read.

The traced calls run under ``torch.profiler`` (host and device activity)
inside the ``benchmark.traced`` range, each call inside ``benchmark.call``.
The trace stays in memory: :func:`summarize` keeps the device operations
(name, start, end, device), the count of the benchmark's generator ranges
(one a call of the generator: a chunk, or a shard of one over a mesh) and
the device operations launched under them, and the host's events for naming
idle gaps.  Times are in
microseconds, on the profiler's clock.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .model import GENERATOR_RANGE

TRACED_RANGE = "benchmark.traced"
CALL_RANGE = "benchmark.call"


@dataclass
class Trace:
    """What a traced window leaves for the metrics."""

    window: tuple  # (start, end) of the traced range, µs
    devices: list  # the device indices the run uses
    calls: int
    ops: list = field(default_factory=list)  # (name, start, end, device)
    generator_calls: int = 0
    generator_us: float = 0.0
    generator_ops: int = 0
    host: list = field(default_factory=list)  # (name, start, end) of the host's events

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self, device) -> float:
        """Microseconds of the window in which an operation ran on ``device``."""
        return union_us([(a, b) for _, a, b, d in self.ops if d == device], *self.window)

    def mean_busy_us(self) -> float:
        return sum(self.busy_us(d) for d in self.devices) / len(self.devices)

    def op_us(self, predicate=lambda name: True) -> float:
        return sum(b - a for name, a, b, _ in self.ops if predicate(name))

    def count(self, predicate=lambda name: True) -> int:
        return sum(1 for name, *_ in self.ops if predicate(name))

    def top_ops(self, n: int = 10) -> list:
        """``[name, seconds]`` of the ``n`` device operations that took most
        time, summed by name."""
        by_name: dict = {}
        for name, a, b, _ in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda item: -item[1])[:n]
        return [[name[:160], us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> list:
        """``[what the host was doing, seconds]`` of the ``n`` longest gaps in
        which a device of the run ran nothing: named by the innermost host
        event under way at the gap's start, inside the benchmark's range."""
        gaps = []
        for d in self.devices:
            gaps += [(b - a, a) for a, b in free_intervals(
                [(a, b) for _, a, b, dev in self.ops if dev == d], *self.window)]
        gaps.sort(reverse=True)
        return [[self.host_at(start), us / 1e6] for us, start in gaps[:n]]

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost benchmark range,
        the innermost operation and the innermost CUDA call under way."""
        under = [name for *_, name in sorted((a, -b, name) for name, a, b in self.host
                                             if a <= t < b)]  # outermost first
        parts = [next((n for n in reversed(under) if n.startswith("benchmark.")),
                      "outside the benchmark's ranges")]
        parts += [n for n in (
            next((n for n in reversed(under) if not n.startswith(("benchmark.", "cu"))), None),
            next((n for n in reversed(under) if n.startswith("cu")), None)) if n]
        return " > ".join(parts)[:160]


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def free_intervals(intervals, lo: float, hi: float) -> list:
    """The (start, end) pieces of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def _subtree_kernels(event):
    """(count, µs) of the device operations launched under a host event."""
    n = len(event.kernels)
    us = sum(k.duration for k in event.kernels)
    for child in event.cpu_children:
        cn, cu = _subtree_kernels(child)
        n, us = n + cn, us + cu
    return n, us


def summarize(events, devices: list, calls: int) -> Trace:
    """A :class:`Trace` of the profiler's events (``prof.events()``)."""
    from torch.autograd import DeviceType

    window = next((e.time_range.start, e.time_range.end) for e in events
                  if e.name == TRACED_RANGE and e.device_type == DeviceType.CPU)
    trace = Trace(window=window, devices=list(devices), calls=calls)
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("benchmark."):
                trace.ops.append((e.name, e.time_range.start, e.time_range.end, e.device_index))
            continue
        a, b = e.time_range.start, e.time_range.end
        trace.host.append((e.name, a, b))
        if e.name == GENERATOR_RANGE:
            trace.generator_calls += 1
            n, us = _subtree_kernels(e)
            trace.generator_ops += n
            trace.generator_us += us
    return trace


def traced_calls(call, calls: int, sync, devices: list, on_card: bool):
    """``call()`` ``calls`` times under the profiler, each followed by
    ``sync()``: (the last result, its :class:`Trace`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    result = None
    with profile(activities=activities) as prof:
        with record_function(TRACED_RANGE):
            for _ in range(calls):
                with record_function(CALL_RANGE):
                    result = call()
                    sync()
    return result, summarize(prof.events(), devices, calls)
