"""Batched numeric kernels over ``(n_obs, S)`` tensors."""

from .lse import logsumexp
from .psis import (
    psislw_batch,
    psislw_compact_batch,
    sislw_batch,
    tail_length,
    tislw_batch,
)

__all__ = [
    "logsumexp",
    "tail_length",
    "psislw_batch",
    "psislw_compact_batch",
    "sislw_batch",
    "tislw_batch",
]
