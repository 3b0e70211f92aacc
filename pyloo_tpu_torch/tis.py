"""Truncated importance sampling: public API (reference ``pyloo/tis.py``)."""

from __future__ import annotations

from .base import ISMethod, compute_importance_weights

__all__ = ["tislw"]


def tislw(log_weights):
    """Truncated importance sampling (Ionides 2008).

    Returns the truncated, normalized log weights and the effective sample
    size per observation.
    """
    lw, ess = compute_importance_weights(log_weights, method=ISMethod.TIS)
    if hasattr(ess, "rename"):
        ess = ess.rename("ess")
    return lw, ess
