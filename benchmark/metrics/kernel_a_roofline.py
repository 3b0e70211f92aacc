"""Kernel A's share of its bytes bound, in %: every row of a call read
once and the tail's values and three sums a row written once, at the HBM
rate, over kernel A's device time a call."""

from benchmark import measure


def read(ctx):
    t = ctx.trace
    if t is None or not t.count(measure.is_kernel_a):
        return None
    seconds = t.op_us(measure.is_kernel_a) / 1e6 / t.calls
    return measure.roofline_pct(ctx.case.kernel_a_bytes_per_call, 0.0, seconds)
