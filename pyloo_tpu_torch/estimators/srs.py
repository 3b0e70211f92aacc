"""Simple random sampling estimator (WOR, with finite-population correction).

Reference: ``pyloo/estimators/srs.py``.
"""

from __future__ import annotations

import numpy as np

from .base import BaseEstimate

__all__ = ["SimpleRandomSamplingEstimator", "srs_estimate", "estimate_elpd_loo"]


class SimpleRandomSamplingEstimator:
    """Population-total estimate ``N * mean(y)`` with SRS-WOR variances."""

    def estimate(self, *, y, N) -> BaseEstimate:
        y = np.asarray(y)
        N = int(N)
        m = len(y)
        y_hat = N * np.mean(y)
        sample_var = np.var(y, ddof=1)
        v_y_hat = N**2 * (1 - m / N) * sample_var / m
        hat_v_y = N * sample_var
        return BaseEstimate(
            y_hat=y_hat,
            v_y_hat=v_y_hat,
            hat_v_y=hat_v_y,
            m=m,
            N=N,
            subsampling_SE=np.sqrt(v_y_hat),
        )


def srs_estimate(y, N):
    """SRS estimate of a population total from sampled values."""
    return SimpleRandomSamplingEstimator().estimate(y=y, N=N)


def estimate_elpd_loo(elpd_loo_i, N):
    """SRS elpd estimate from sampled LOO values."""
    return srs_estimate(y=elpd_loo_i, N=N)
