"""Seconds a call of kernels on the card (every device operation but the
copies and fills)."""

from benchmark import measure


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops:
        return None
    return t.op_us(lambda name: not measure.is_copy(name)) / 1e6 / t.calls
