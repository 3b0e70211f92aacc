"""Host seconds a traced call of ``loo()``'s ingest (``pyloo.loo.ingest``): the
host draws made a matrix on the card and scanned for NaN; the pageable copy
blocks the host here."""

from benchmark.spans import per_call_span


def read(ctx):
    return per_call_span(ctx, "pyloo.loo.ingest", 1e-6)
