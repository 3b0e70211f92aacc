"""Host milliseconds a traced call of the subsample's draw
(``pyloo.subsample.draw``, numpy)."""

from benchmark.spans import per_call_span


def read(ctx):
    return per_call_span(ctx, "pyloo.subsample.draw", 1e-3)
