"""Batched numeric kernels over ``(n_obs, S)`` tensors."""

from .ess import ess_mean, relative_eff
from .lse import logsumexp
from .psis import (
    compact_weighted_mean,
    compact_weighted_moments,
    gpdfit,
    gpinv,
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
    "compact_weighted_mean",
    "compact_weighted_moments",
    "sislw_batch",
    "tislw_batch",
    "gpdfit",
    "gpinv",
    "ess_mean",
    "relative_eff",
]
