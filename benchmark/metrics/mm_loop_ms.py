"""Host milliseconds a traced call of the greedy loop's passes
(``pyloo.moment_match.pass``, one a pass of a block of lanes): the
lanes' transforms, their evaluations and PSIS re-fits queued, and the read
of the lanes still active after each."""

from benchmark.spans import per_call_span


def read(ctx):
    return per_call_span(ctx, "pyloo.moment_match.pass", 1e-3)
