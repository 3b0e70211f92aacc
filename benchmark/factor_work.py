"""The fixed work of a non-factorised call and the peak it is set against.

Whatever implements it, a draw's ``(N, N)`` covariance is factorised
(``N^3 / 3`` flops, Cholesky) and its factor inverted (``N^3 / 3``): the
count of the layer's work, set against the H100 SXM's float64 tensor-core
peak (NVIDIA's data sheet, dense, at 700 W).  The matrices' bytes are each
draw's matrix written once and read once.
"""

from __future__ import annotations

from benchmark.measure import HBM_BYTES_PER_S

FP64_TC_FLOPS_PER_S = 67e12  # float64 on the tensor cores (DMMA)


def factor_flops(n: int, draws: int) -> float:
    """Flops of ``draws`` factorisations and inverse factors of ``n x n``."""
    return draws * 2.0 * n ** 3 / 3.0


def matrix_bytes(n: int, draws: int) -> float:
    """Each draw's float64 ``n x n`` matrix written once and read once."""
    return draws * 2.0 * 8 * n * n


def least_seconds(n: int, draws: int) -> float:
    """The least time of a call's matrices: their flops at the float64 peak
    or their bytes at the HBM rate, whichever is longer."""
    return max(factor_flops(n, draws) / FP64_TC_FLOPS_PER_S,
               matrix_bytes(n, draws) / HBM_BYTES_PER_S)
