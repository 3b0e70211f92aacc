"""GB of host memory the program hands to the card a traced call through
its ring of pinned staging buffers (the ``h2d_staged_bytes`` counter): all
of the host draws' ``h2d_bytes`` where the ring takes them.  A program with
the ring that copied nothing through it reads 0; a program without it reads
nothing."""

from importlib.util import find_spec

from benchmark.measure import traced
from benchmark.spans import per_call_counter


def _keeps_the_counter() -> bool:
    from pyloo_tpu_torch import profiling

    return hasattr(profiling, "counters") and find_spec("pyloo_tpu_torch._staging") is not None


def read(ctx):
    gb = per_call_counter(ctx, "h2d_staged_bytes", 1e-9)
    if gb is None and traced(ctx) is not None and _keeps_the_counter():
        return 0.0
    return gb
