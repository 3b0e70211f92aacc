"""Plain NumPy float64 PSIS, one observation at a time: the verification tools' oracle.

Written from the papers and independent of the code under test: Pareto
smoothed importance sampling after Vehtari, Simpson, Gelman, Yao and Gabry
(2024, JMLR 25(72)) and the empirical-Bayes GPD fit of Zhang and Stephens
(2009).  ``validate_kernels`` holds the port's float64 ``psislw`` on the
card to :func:`psis_matrix`.  It imports numpy only.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fit_gpd_zhang_stephens", "gpd_quantile", "psis_row", "psis_matrix"]


def fit_gpd_zhang_stephens(sorted_exceedances):
    """Empirical-Bayes GPD (k, sigma) estimate for an ascending 1-D sample."""
    y = np.asarray(sorted_exceedances, dtype=np.float64)
    n = y.size
    # candidate grid for theta = -k/sigma, from the first-quartile and the
    # largest order statistics
    n_grid = 30 + int(np.floor(np.sqrt(n)))
    j = np.arange(1, n_grid + 1, dtype=np.float64)
    quartile = y[int(n / 4.0 + 0.5) - 1]
    theta = 1.0 / y[-1] + (1.0 - np.sqrt(n_grid / (j - 0.5))) / (3.0 * quartile)

    # profile log-likelihood of each candidate
    k_of_theta = np.array([np.mean(np.log1p(-t * y)) for t in theta])
    ell = n * (np.log(-theta / k_of_theta) - k_of_theta - 1.0)

    # posterior weights over the grid, negligible ones dropped
    post = np.exp(ell - ell.max())
    post /= post.sum()
    post[post < 10 * np.finfo(np.float64).eps] = 0.0
    post /= post.sum()

    theta_hat = float(np.sum(theta * post))
    k_hat = float(np.mean(np.log1p(-theta_hat * y)))
    sigma_hat = -k_hat / theta_hat
    # weakly informative prior, shrinking k towards 0.5
    k_hat = (n * k_hat + 5.0) / (n + 10.0)
    return k_hat, sigma_hat


def gpd_quantile(p, k, sigma):
    """Inverse CDF of the GPD with shape k and scale sigma at probabilities p."""
    p = np.asarray(p, dtype=np.float64)
    if sigma <= 0:
        return np.full_like(p, np.nan)
    if abs(k) < np.finfo(np.float64).eps:
        return sigma * (-np.log1p(-p))
    return sigma * np.expm1(-k * np.log1p(-p)) / k


def psis_row(raw_log_weights, reff=1.0):
    """PSIS for one observation's log-weight vector: ``(lw, k_hat)``."""
    lw = np.array(raw_log_weights, dtype=np.float64)
    S = lw.size
    lw = lw - lw.max()

    n_tail_max = int(np.ceil(min(S / 5.0, 3.0 * np.sqrt(S / reff))))
    order = np.argsort(lw, kind="stable")
    threshold = max(lw[order[S - n_tail_max - 1]], np.log(np.finfo(float).tiny))

    tail_mask = lw > threshold
    n_tail = int(tail_mask.sum())
    if n_tail <= 4:
        k_hat = np.inf
    else:
        tail_positions = np.nonzero(tail_mask)[0]
        rank = np.argsort(lw[tail_positions], kind="stable")
        exceed = np.exp(lw[tail_positions][rank]) - np.exp(threshold)
        k_hat, sigma_hat = fit_gpd_zhang_stephens(exceed)
        if np.isfinite(k_hat):
            plotting_pos = (np.arange(n_tail) + 0.5) / n_tail
            smoothed = np.log(gpd_quantile(plotting_pos, k_hat, sigma_hat) + np.exp(threshold))
            lw[tail_positions[rank]] = smoothed
            lw[lw > 0] = 0.0

    shifted = lw - lw.max()
    lw = lw - (np.log(np.sum(np.exp(shifted))) + lw.max())
    return lw, k_hat


def psis_matrix(lw_matrix, reff=1.0):
    """:func:`psis_row` over the rows of an ``(n_obs, S)`` matrix."""
    lw_matrix = np.asarray(lw_matrix, dtype=np.float64)
    out = np.empty_like(lw_matrix)
    ks = np.empty(lw_matrix.shape[0])
    for i, row in enumerate(lw_matrix):
        out[i], ks[i] = psis_row(row, reff)
    return out, ks
