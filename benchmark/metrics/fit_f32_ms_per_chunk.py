"""The float32 fit's device milliseconds a chunk: every device operation's
time outside the benchmark's generator range and outside kernel A."""

from benchmark import measure


def read(ctx):
    t = measure.chunked(ctx)
    if t is None:
        return None
    us = t.op_us() - t.generator_us - t.op_us(measure.is_kernel_a)
    return measure.per_chunk(us, ctx) / 1e3
