"""Weighted Hansen-Hurwitz estimator for PPS sampling with replacement.

Reference: ``pyloo/estimators/hansen_hurwitz.py`` (Magnusson et al. 2019,
arXiv:1902.06504).
"""

from __future__ import annotations

import numpy as np

from .base import BaseEstimate

__all__ = [
    "HansenHurwitzEstimator",
    "hansen_hurwitz_estimate",
    "compute_sampling_probabilities",
    "estimate_elpd_loo",
]


class HansenHurwitzEstimator:
    """``y_hat = (1/m) sum(m_i y_i / z_i)`` with PPS design variances.

    ``z`` must be the *population*-normalized selection probabilities (sum to
    1 over all N observations), as in R loo's ``whhest``.  The reference
    implementation renormalizes z over the sample
    (``estimators/hansen_hurwitz.py:71``), which silently rescales the
    population-total estimate by roughly m/N x; that renormalization is
    deliberately omitted here so hh_pps subsample estimates actually converge
    to the full-LOO elpd.
    """

    def estimate(self, *, z, m_i, y, N) -> BaseEstimate:
        z = np.asarray(z)
        m_i = np.asarray(m_i)
        y = np.asarray(y)
        N = int(N)

        if not np.all(z > 0):
            raise ValueError("All probabilities (z) must be positive")
        if not np.all(m_i > 0):
            raise ValueError("All sample counts (m_i) must be positive")
        if not len(z) == len(m_i) == len(y):
            raise ValueError("All input arrays must have same length")

        m = np.sum(m_i)
        y_hat = np.sum(m_i * (y / z)) / m
        v_y_hat = (np.sum(m_i * ((y / z - y_hat) ** 2)) / m) / (m - 1)
        hat_v_y = (np.sum(m_i * (y**2 / z)) / m) + v_y_hat / N - y_hat**2 / N

        return BaseEstimate(
            y_hat=y_hat,
            v_y_hat=v_y_hat,
            hat_v_y=hat_v_y,
            m=int(m),
            N=N,
            subsampling_SE=np.sqrt(v_y_hat),
        )


def compute_sampling_probabilities(elpd_loo_approximation):
    """PPS probabilities proportional to |elpd_approx| (uniform fallback)."""
    pi_values = np.abs(np.asarray(elpd_loo_approximation))
    if np.all(pi_values <= 0):
        pi_values = np.ones_like(pi_values)
    pi_values = np.maximum(pi_values, np.finfo(float).tiny)
    return pi_values / np.sum(pi_values)


def hansen_hurwitz_estimate(z, m_i, y, N):
    """Weighted Hansen-Hurwitz estimate of a population total."""
    return HansenHurwitzEstimator().estimate(z=z, m_i=m_i, y=y, N=N)


def estimate_elpd_loo(elpd_loo_i, elpd_loo_approximation, sample_indices, m_i, N):
    """HH-PPS elpd estimate from sampled LOO values."""
    z = compute_sampling_probabilities(elpd_loo_approximation)
    return hansen_hurwitz_estimate(
        z=z[sample_indices], m_i=m_i, y=elpd_loo_i, N=N
    )
