"""Batched numeric kernels over ``(n_obs, S)`` tensors."""

from .lse import logsumexp
from .psis import sislw_batch, tail_length, tislw_batch

__all__ = ["logsumexp", "tail_length", "sislw_batch", "tislw_batch"]
