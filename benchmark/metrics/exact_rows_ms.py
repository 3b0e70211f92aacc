"""Host milliseconds a traced call of the sampled rows' exact scoring
(``pyloo.subsample.exact_rows``): made in float64, scored, the guard's read and
the copies back."""

from benchmark.spans import per_call_span


def read(ctx):
    return per_call_span(ctx, "pyloo.subsample.exact_rows", 1e-3)
