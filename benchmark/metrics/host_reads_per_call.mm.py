"""The program's reads from the device to the host a traced call, summed
over its funnels (the ``host_reads`` counter): the first PSIS's, the
moment-matching loop's (``moment_match.*``: the lanes' log-likelihood, one
a pass, the results, the split's halves and evaluations) and the deep-tail
guard's."""

from benchmark.spans import per_call_counter


def read(ctx):
    return per_call_counter(ctx, "host_reads")
