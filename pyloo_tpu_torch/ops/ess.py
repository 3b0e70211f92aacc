"""Effective sample size (mean method) and relative efficiency.

Implements the split-chain ESS of Vehtari, Gelman, Simpson, Carpenter,
Bürkner (2021, Bayesian Analysis) — autocovariance via FFT, Geyer's initial
positive + monotone sequence — which is what the reference delegates to
``arviz.stats.diagnostics.ess(posterior, method="mean")`` when computing
``reff`` (reference ``pyloo/loo.py:204-216``).

The per-series combine step is a short sequential recurrence, so it runs
vectorized in NumPy on host: posterior parameter counts are tiny next to the
``(n_obs, S)`` tensors that the device kernels own.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ess_mean", "relative_eff", "rhat"]


def _autocovariance(ary: np.ndarray) -> np.ndarray:
    """Biased autocovariance along the last axis via FFT (per chain)."""
    n = ary.shape[-1]
    m = int(2 ** np.ceil(np.log2(2 * n)))
    centered = ary - ary.mean(axis=-1, keepdims=True)
    freq = np.fft.rfft(centered, n=m, axis=-1)
    acov = np.fft.irfft(freq * np.conjugate(freq), n=m, axis=-1)[..., :n].real
    return acov / n


def _split_chains(ary: np.ndarray) -> np.ndarray:
    """(..., C, N) -> (..., 2C, N//2): first and second half of every chain."""
    half = ary.shape[-1] // 2
    return np.concatenate([ary[..., :half], ary[..., -half:]], axis=-2)


def _ess_single(mean_var: float, var_plus: float, mean_acov: np.ndarray, total: int):
    """Combine averaged autocovariances into one ESS (Geyer sequences)."""
    n = mean_acov.shape[0]
    rho_hat = np.zeros(n)
    rho_hat[0] = 1.0
    rho_even = 1.0
    rho_odd = 1.0 - (mean_var - mean_acov[1]) / var_plus
    rho_hat[1] = rho_odd

    # initial positive sequence: extend in pairs while the pair sum is positive
    t = 1
    while t < (n - 3) and (rho_even + rho_odd) > 0.0:
        rho_even = 1.0 - (mean_var - mean_acov[t + 1]) / var_plus
        rho_odd = 1.0 - (mean_var - mean_acov[t + 2]) / var_plus
        if (rho_even + rho_odd) >= 0:
            rho_hat[t + 1] = rho_even
            rho_hat[t + 2] = rho_odd
        t += 2
    max_t = t - 2
    if rho_even > 0:
        rho_hat[max_t + 1] = rho_even

    # initial monotone sequence: enforce non-increasing pair sums
    t = 1
    while t <= max_t - 2:
        if (rho_hat[t + 1] + rho_hat[t + 2]) > (rho_hat[t - 1] + rho_hat[t]):
            rho_hat[t + 1] = (rho_hat[t - 1] + rho_hat[t]) / 2.0
            rho_hat[t + 2] = rho_hat[t + 1]
        t += 2

    tau_hat = -1.0 + 2.0 * rho_hat[: max_t + 1].sum() + rho_hat[max_t + 1]
    tau_hat = max(tau_hat, 1.0 / np.log10(total))
    return total / tau_hat


def _ess_core(ary: np.ndarray) -> np.ndarray:
    """ESS for a batch of series: ary shape (K, C, N) -> (K,)."""
    K, C, N = ary.shape
    acov = _autocovariance(ary)  # (K, C, N)
    chain_mean = ary.mean(axis=-1)  # (K, C)
    mean_var = acov[..., 0].mean(axis=-1) * N / (N - 1.0)  # (K,)
    var_plus = mean_var * (N - 1.0) / N
    if C > 1:
        var_plus = var_plus + chain_mean.var(axis=-1, ddof=1)
    mean_acov = acov.mean(axis=-2)  # (K, N)

    total = C * N
    out = np.empty(K)
    for kk in range(K):
        if not np.all(np.isfinite(ary[kk])):
            out[kk] = np.nan
            continue
        out[kk] = _ess_single(mean_var[kk], var_plus[kk], mean_acov[kk], total)
    return out


def ess_mean(ary: np.ndarray) -> np.ndarray:
    """Split-chain ESS of the mean for an array shaped (chain, draw, *extra).

    Returns an array shaped like ``extra`` (scalar for a 0-d parameter).
    """
    ary = np.asarray(ary, dtype=np.float64)
    if ary.ndim < 2:
        ary = ary.reshape((1,) + ary.shape)
    C, N = ary.shape[:2]
    extra = ary.shape[2:]
    series = ary.reshape(C, N, -1).transpose(2, 0, 1)  # (K, C, N)
    series = _split_chains(series)
    if series.shape[-1] < 4:
        out = np.full(series.shape[0], np.nan)
    else:
        out = _ess_core(series)
    return out.reshape(extra) if extra else float(out[0])


def relative_eff(posterior_vars: dict[str, np.ndarray], n_samples: int) -> float:
    """reff = mean ESS over all posterior parameter elements / n_samples.

    ``posterior_vars`` maps variable name -> (chain, draw, *extra) array;
    mirrors reference ``pyloo/loo.py:204-216``.
    """
    all_ess = []
    for values in posterior_vars.values():
        e = ess_mean(np.asarray(values))
        all_ess.append(np.atleast_1d(np.asarray(e)).ravel())
    if not all_ess:
        return 1.0
    return float(np.hstack(all_ess).mean() / n_samples)


def rhat(ary: np.ndarray) -> float:
    """Split-R-hat convergence diagnostic (Vehtari et al. 2021, eq. 3.1).

    ``ary`` is (chain, draw) for one scalar parameter.  Chains are split in
    half; R-hat compares between- and within-chain variance of the 2C
    half-chains.  Values near 1.0 indicate convergence; > 1.01 is suspect.
    """
    ary = np.asarray(ary, dtype=np.float64)
    if ary.ndim != 2:
        raise ValueError(f"rhat expects (chain, draw), got shape {ary.shape}")
    split = _split_chains(ary)  # (2C, N//2)
    m, n = split.shape
    chain_means = split.mean(axis=1)
    chain_vars = split.var(axis=1, ddof=1)
    between = n * np.var(chain_means, ddof=1)
    within = chain_vars.mean()
    var_plus = (n - 1) / n * within + between / n
    return float(np.sqrt(var_plus / within))
