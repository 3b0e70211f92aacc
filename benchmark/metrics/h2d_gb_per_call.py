"""GB of host memory the program hands to the card a traced call, summed
over its kinds (the ``h2d_bytes`` counter: the ingest of the host draws)."""

from benchmark.spans import per_call_counter


def read(ctx):
    return per_call_counter(ctx, "h2d_bytes", 1e-9)
