"""Difference estimator under simple random sampling without replacement.

Point estimate: ``y_hat = sum(y_approx) + N * mean(y_i - y_approx_i)`` over
the sampled set; variance decomposition per Magnusson, Andersen, Jonasson,
Vehtari (2020), arXiv:2001.09660.  Reference: ``pyloo/estimators/difference.py``.
"""

from __future__ import annotations

import numpy as np

from .base import BaseEstimate

__all__ = ["DifferenceEstimator", "diff_srs_estimate"]


def _reduce_extra_dims(a: np.ndarray) -> np.ndarray:
    return a.mean(axis=tuple(range(1, a.ndim))) if a.ndim > 1 else a


class DifferenceEstimator:
    """SRS-WOR difference estimator with an auxiliary approximation vector."""

    def estimate(self, *, y_approx, y, y_idx) -> BaseEstimate:
        """Estimate the population total of y from a sample plus y_approx.

        ``y_approx`` covers all N observations; ``y`` the sampled values at
        positions ``y_idx``.
        """
        y_approx = np.asarray(y_approx)
        y = np.asarray(y)
        y_idx = np.asarray(y_idx)

        if len(y) != len(y_idx):
            raise ValueError("y and y_idx must have same length")
        if y_idx.size and np.max(y_idx) >= len(y_approx):
            raise ValueError("y_idx contains invalid indices")

        N = len(y_approx)
        m = len(y)
        y_approx_m = y_approx[y_idx]

        y = _reduce_extra_dims(y)
        y_approx_m = _reduce_extra_dims(y_approx_m)
        y_approx = _reduce_extra_dims(y_approx)

        e_i = y - y_approx_m
        t_pi_tilde = np.sum(y_approx)
        t_pi2_tilde = np.sum(y_approx**2)
        t_e = N * np.mean(e_i)
        t_hat_epsilon = N * np.mean(y**2 - y_approx_m**2)
        y_hat = t_pi_tilde + t_e

        if m > 1:
            v_y_hat = (N**2) * (1 - m / N) * np.var(e_i, ddof=1) / m
            hat_v_y = (t_pi2_tilde + t_hat_epsilon) - (1 / N) * (
                t_e**2 - v_y_hat + 2 * t_pi_tilde * y_hat - t_pi_tilde**2
            )
        else:
            v_y_hat = np.inf
            hat_v_y = np.inf

        return BaseEstimate(
            y_hat=y_hat,
            v_y_hat=v_y_hat,
            hat_v_y=hat_v_y,
            m=m,
            N=N,
            subsampling_SE=np.sqrt(v_y_hat),
        )


def diff_srs_estimate(elpd_loo_i, elpd_loo_approximation, sample_indices):
    """Difference-estimator elpd estimate from sampled LOO values."""
    return DifferenceEstimator().estimate(
        y_approx=elpd_loo_approximation, y=elpd_loo_i, y_idx=sample_indices
    )
