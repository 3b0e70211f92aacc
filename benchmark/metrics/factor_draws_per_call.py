"""The draws whose matrices the program factorised or applied a traced
call (the ``factor_draws`` counter, by form): every draw of the cell."""

from benchmark.spans import per_call_counter


def read(ctx):
    return per_call_counter(ctx, "factor_draws")
