"""The factorisation layer's share of its bound, in %: each draw's
Cholesky factorisation and inverse factor (N^3 / 3 flops each,
``benchmark/factor_work.py``) at the float64 tensor-core peak, over the
device time outside the benchmark's generator range a call."""

from benchmark import factor_work, measure


def read(ctx):
    t = measure.chunked(ctx)
    if t is None:
        return None
    seconds = (t.op_us() - t.generator_us) / 1e6 / t.calls
    if seconds <= 0:
        return None
    return 100.0 * ctx.case.factor_flops / factor_work.FP64_TC_FLOPS_PER_S / seconds
