"""Host milliseconds of one ``pyloo.chunk.score`` span, the mean over the
traced window: queueing kernel A, the float32 fit and the carry update of
one shard of one chunk (a guard rerun is a span of its own)."""

from benchmark.measure import traced
from benchmark.spans import span_count, span_s

NAME = "pyloo.chunk.score"


def read(ctx):
    t = traced(ctx)
    n = span_count(t, NAME) if t is not None else 0
    return span_s(t, NAME) / n / 1e3 if n else None
