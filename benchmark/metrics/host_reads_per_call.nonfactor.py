"""The program's reads from the device to the host a traced call, summed
over its funnels (the ``host_reads`` counter): the dropped-draw decision,
the guard's flags and the scores."""

from benchmark.spans import per_call_counter


def read(ctx):
    return per_call_counter(ctx, "host_reads")
