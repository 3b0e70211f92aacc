"""The program's own spans and counters, read for the per-layer metrics.

The port names the phases of its entry points with host ranges in the
profiler's trace (``pyloo.loo.ingest``, ``pyloo.chunk.score``, ...) and
counts its reads of the device and its copies to it while a profiler
records (``pyloo_tpu_torch.profiling.counters()``).  The only window with
a profiler on is the traced one, so the counters hold its calls' work.  A
program without them reads nothing here: each reader then returns None.

A reader reads only a traced window that holds device operations (a run on
the card): a CPU rehearsal's spans time the CPU's kernels, not the card's
host phases, and its line carries no per-layer metric.  Times are in
microseconds, on the profiler's clock.
"""

from __future__ import annotations

from benchmark.measure import traced


def span_s(trace, name: str) -> float:
    """The summed host wall of the spans ``name``, clipped to the traced
    window, in µs."""
    lo, hi = trace.window
    return sum(max(0.0, min(b, hi) - max(a, lo)) for n, a, b in trace.host if n == name)


def span_count(trace, name: str) -> int:
    return sum(1 for n, *_ in trace.host if n == name)


def counter_total(name: str):
    """The sum of the program's counter ``name`` over its keys, or None
    where the program keeps no such counter."""
    from pyloo_tpu_torch import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    per = counters().get(name)
    return None if per is None else float(sum(per.values()))


def per_call_span(ctx, name: str, scale: float):
    """Span ``name``'s wall a traced call, in µs times ``scale``; None
    where the window or the span is missing."""
    t = traced(ctx)
    if t is None or not span_count(t, name):
        return None
    return span_s(t, name) * scale / t.calls


def per_call_counter(ctx, name: str, scale: float = 1.0):
    """Counter ``name``'s total a traced call, times ``scale``; None where
    the window or the counter is missing."""
    t = traced(ctx)
    total = counter_total(name) if t is not None else None
    return None if total is None else total * scale / t.calls
