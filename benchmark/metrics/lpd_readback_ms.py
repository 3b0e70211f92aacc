"""Host milliseconds a traced call of the LPD's readback
(``pyloo.subsample.readback``): the wait for the LPD pass and the copy of its
n_obs values to the host, as float64."""

from benchmark.spans import per_call_span


def read(ctx):
    return per_call_span(ctx, "pyloo.subsample.readback", 1e-3)
