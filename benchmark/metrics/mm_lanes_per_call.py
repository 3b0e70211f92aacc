"""The rows matched a traced call, those whose first Pareto k exceeds the
threshold (the ``mm_lanes`` counter): the traffic's witness, which the seed
fixes."""

from benchmark.spans import per_call_counter


def read(ctx):
    return per_call_counter(ctx, "mm_lanes")
