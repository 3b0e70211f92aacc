"""Host milliseconds a traced call of the split transforms
(``pyloo.moment_match.split``, one a lane that accepted a transform): the
inverse and determinant of the lane's map, the two halves' evaluations and
the smoothing of their mixture weights."""

from benchmark.spans import per_call_span


def read(ctx):
    return per_call_span(ctx, "pyloo.moment_match.split", 1e-3)
