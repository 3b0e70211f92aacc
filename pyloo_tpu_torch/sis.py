"""Standard importance sampling: public API (reference ``pyloo/sis.py``)."""

from __future__ import annotations

from .base import ISMethod, compute_importance_weights

__all__ = ["sislw"]


def sislw(log_weights):
    """Standard importance sampling: self-normalize log weights.

    Returns the normalized log weights and the effective sample size
    ``1 / sum(w^2)`` per observation.
    """
    lw, ess = compute_importance_weights(log_weights, method=ISMethod.SIS)
    if hasattr(ess, "rename"):
        ess = ess.rename("ess")
    return lw, ess
