"""The rows that kernel F, the float32 tail fit (``csrc/psis_tail_fit.cu``),
scored a traced call (the ``fit_kernel_rows`` counter): the streamed
float32 cell's every row when the fit runs as the one kernel.  A program
with the kernel and its counter that launched it on no row (a CPU
rehearsal) reads 0; a program without them reads nothing."""

from benchmark.measure import traced
from benchmark.spans import per_call_counter


def _keeps_the_counter() -> bool:
    from pyloo_tpu_torch import profiling
    from pyloo_tpu_torch.ops import loo_kernels

    return hasattr(profiling, "counters") and hasattr(loo_kernels, "psis_tail_fit")


def read(ctx):
    rows = per_call_counter(ctx, "fit_kernel_rows")
    if rows is None and traced(ctx) is not None and _keeps_the_counter():
        return 0.0
    return rows
