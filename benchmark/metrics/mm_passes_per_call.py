"""The greedy loop's passes a traced call, summed over the tail-length
groups (the ``mm_passes`` counter)."""

from benchmark.spans import per_call_counter


def read(ctx):
    return per_call_counter(ctx, "mm_passes")
