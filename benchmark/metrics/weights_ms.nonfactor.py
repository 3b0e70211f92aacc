"""Host milliseconds a traced call of the non-factorised estimator's
importance weights (``pyloo.nonfactor.weights``): the float64 PSIS of
every observation queued, its guard's read, and the read of the scores."""

from benchmark.spans import per_call_span


def read(ctx):
    return per_call_span(ctx, "pyloo.nonfactor.weights", 1e-3)
