"""The benchmark's plain float64 reference: PSIS-LOO one row at a time.

Written from the papers, independent of the code under test: Pareto
smoothed importance sampling after Vehtari, Simpson, Gelman, Yao and Gabry
(2024, JMLR 25(72)), the empirical-Bayes GPD fit of Zhang and Stephens
(2009), and the split-chain effective sample size of the mean after
Vehtari, Gelman, Simpson, Carpenter and Bürkner (2021, Bayesian Analysis)
for the relative efficiency.  Plain numpy in float64, one observation and
one parameter at a time; it imports nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np


def tail_length(n_samples: int, reff: float = 1.0) -> int:
    """PSIS tail length M = ceil(min(S / 5, 3 sqrt(S / reff)))."""
    return int(math.ceil(min(n_samples / 5.0, 3.0 * math.sqrt(n_samples / reff))))


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


def psis_row(raw_log_weights, reff: float = 1.0):
    """PSIS of one observation's log-weights: (normalised log-weights, k-hat)."""
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


def loo_row(log_lik_row, reff: float = 1.0):
    """One observation's PSIS-LOO: (elpd_loo_i, k-hat), with the log-weights
    of ``-log_lik`` and elpd_loo_i = log sum_s w_s p(y_i | theta_s)."""
    ll = np.asarray(log_lik_row, dtype=np.float64)
    lw, k_hat = psis_row(-ll, reff)
    terms = lw + ll
    top = terms.max()
    return float(np.log(np.sum(np.exp(terms - top))) + top), float(k_hat)


def loo_rows(log_lik, reff: float = 1.0):
    """:func:`loo_row` over the rows of an (n_rows, S) array: (loo_i, k)."""
    log_lik = np.asarray(log_lik, dtype=np.float64)
    out = np.array([loo_row(row, reff) for row in log_lik]).reshape(-1, 2)
    return out[:, 0], out[:, 1]


def _autocovariance(x):
    """Biased autocovariance of one series at every lag."""
    c = x - x.mean()
    return np.correlate(c, c, mode="full")[x.size - 1 :] / x.size


def ess_mean(chains):
    """Split-chain ESS of the mean of one scalar parameter, (chain, draw)."""
    chains = np.asarray(chains, dtype=np.float64)
    half = chains.shape[1] // 2
    split = np.concatenate([chains[:, :half], chains[:, -half:]])
    m, n = split.shape
    acov = np.array([_autocovariance(s) for s in split])
    mean_var = acov[:, 0].mean() * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus += split.mean(axis=1).var(ddof=1)

    def rho(t):
        return 1.0 - (mean_var - acov[:, t].mean()) / var_plus

    rho_hat = np.zeros(n)
    rho_hat[0] = rho_even = 1.0
    rho_hat[1] = rho_odd = rho(1)
    # Geyer's initial positive sequence
    t = 1
    while t < n - 3 and rho_even + rho_odd > 0.0:
        rho_even, rho_odd = rho(t + 1), rho(t + 2)
        if rho_even + rho_odd >= 0:
            rho_hat[t + 1], rho_hat[t + 2] = rho_even, rho_odd
        t += 2
    max_t = t - 2
    if rho_even > 0:
        rho_hat[max_t + 1] = rho_even
    # Geyer's initial monotone sequence
    t = 1
    while t <= max_t - 2:
        if rho_hat[t + 1] + rho_hat[t + 2] > rho_hat[t - 1] + rho_hat[t]:
            rho_hat[t + 1] = rho_hat[t + 2] = (rho_hat[t - 1] + rho_hat[t]) / 2.0
        t += 2
    total = m * n
    tau = -1.0 + 2.0 * rho_hat[: max_t + 1].sum() + rho_hat[max_t + 1]
    return total / max(tau, 1.0 / np.log10(total))


def relative_eff(posterior: dict) -> float:
    """Relative efficiency: the mean ESS over every element of the
    posterior's variables, each (chain, draw, ...), over the draws' count."""
    ess, n_samples = [], None
    for values in posterior.values():
        values = np.asarray(values, dtype=np.float64)
        n_samples = values.shape[0] * values.shape[1]
        series = values.reshape(values.shape[0], values.shape[1], -1)
        ess.extend(ess_mean(series[:, :, j]) for j in range(series.shape[2]))
    return float(np.mean(ess) / n_samples)
