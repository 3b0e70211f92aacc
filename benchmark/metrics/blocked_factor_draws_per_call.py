"""The draws whose covariances the blocked float64 factorisation (batched
products and kernel G, ``csrc/chol_block.cu``) took a traced call (the
``blocked_factor_draws`` counter): the GP cell's every draw when the card
takes the blocked route.  A program with the route and its counter that
ran it on no draw (a CPU rehearsal, an order below the crossover) reads 0;
a program without them reads nothing."""

from benchmark.measure import traced
from benchmark.spans import per_call_counter


def _keeps_the_counter() -> bool:
    from pyloo_tpu_torch import profiling
    from pyloo_tpu_torch.ops import nonfactor

    return hasattr(profiling, "counters") and hasattr(nonfactor, "blocked_cholesky")


def read(ctx):
    draws = per_call_counter(ctx, "blocked_factor_draws")
    if draws is None and traced(ctx) is not None and _keeps_the_counter():
        return 0.0
    return draws
