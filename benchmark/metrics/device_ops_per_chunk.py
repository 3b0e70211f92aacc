"""Device operations a chunk outside the benchmark's generator range (the
scorer's launches, kernel A's among them): a count that repeats exactly."""

from benchmark import measure


def read(ctx):
    t = measure.chunked(ctx)
    return measure.per_chunk(t.count() - t.generator_ops, ctx) if t else None
