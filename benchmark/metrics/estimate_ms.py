"""Host milliseconds a traced call of the survey estimate and the result
(``pyloo.subsample.estimate``)."""

from benchmark.spans import per_call_span


def read(ctx):
    return per_call_span(ctx, "pyloo.subsample.estimate", 1e-3)
