"""Device operations a chunk of draws outside the benchmark's generator
range (the Cholesky factorisation's launches, the inverse factor's, the
terms', and the call's float64 PSIS shared over its chunks): a count that
repeats exactly."""

from benchmark import measure


def read(ctx):
    t = measure.chunked(ctx)
    return measure.per_chunk(t.count() - t.generator_ops, ctx) if t else None
