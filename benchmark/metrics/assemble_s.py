"""Host seconds a traced call of ``loo()``'s assembly (``pyloo.loo.assemble``):
warnings, the pointwise arrays, the sums and the result."""

from benchmark.spans import per_call_span


def read(ctx):
    return per_call_span(ctx, "pyloo.loo.assemble", 1e-6)
