"""The whole call's share of the chip's peak, in %: the least time its
work needs (each draw's factorisation and inverse factor at the float64
tensor-core peak, or each draw's matrix written once and read once at the
HBM rate, whichever is longer; ``benchmark/factor_work.py``) over a traced
call's wall."""

from benchmark.measure import traced


def read(ctx):
    t = traced(ctx)
    if t is None:
        return None
    return 100.0 * ctx.case.least_seconds / (t.window_us / 1e6 / t.calls)
