"""Host seconds a traced call of ``loo()``'s relative efficiency
(``pyloo.loo.reff``): the ESS over the posterior on the host."""

from benchmark.spans import per_call_span


def read(ctx):
    return per_call_span(ctx, "pyloo.loo.reff", 1e-6)
