"""PSIS-LOO-CV for approximate (variational) posteriors.

Counterpart of ``pyloo_tpu/loo_approximate_posterior.py`` (reference
``pyloo/loo_approximate_posterior.py``): given the target and proposal
log-densities at the S proposal draws, the draws are importance-resampled on
the host (PSIS without replacement, PSIR with replacement, or SIS, from
numpy's ``RandomState(seed)``, so the same seed gives the same draws as
``pyloo_tpu``), and the usual LOO scorers run over the reindexed
log-likelihood on the device.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from ._common import clean_log_likelihood, compute_device, compute_reff, good_k_threshold, resolve_scale
from .base import ISMethod, _host, as_sample_matrix
from .containers import DataArray
from .elpd import ELPDData
from .ops import tail_length
from .ops.loo_kernels import loo_scores_psis, loo_scores_sis, loo_scores_tis
from .parallel import apply_rowwise
from .psis import psislw
from .rcparams import rcParams
from .utils import _logsumexp, get_log_likelihood, to_inference_data

__all__ = ["loo_approximate_posterior", "importance_resample"]


def loo_approximate_posterior(
    data,
    log_p: np.ndarray,
    log_q: np.ndarray,
    pointwise: bool | None = None,
    var_name: str | None = None,
    reff: float | None = None,
    scale: str | None = None,
    method="psis",
    resample_method: str = "psis",
    seed: int | None = None,
) -> ELPDData:
    """LOO-CV with a posterior-approximation correction.

    ``log_p`` (target) and ``log_q`` (proposal) are length-S vectors at the
    proposal draws; the draws are importance-resampled before the usual LOO
    computation, which takes the exact scorer whatever the precision.  The
    result gains an ``approximate_posterior`` attribute.
    """
    compute_device()
    inference_data = to_inference_data(data)
    log_likelihood = get_log_likelihood(inference_data, var_name=var_name)
    pointwise = rcParams["stats.ic_pointwise"] if pointwise is None else pointwise

    log_likelihood = log_likelihood.stack(__sample__=("chain", "draw"))
    shape = log_likelihood.shape
    n_samples = shape[-1]
    n_data_points = int(np.prod(shape[:-1]))
    scale, scale_value = resolve_scale(scale)

    reff = compute_reff(inference_data, reff, n_samples)

    try:
        method = method if isinstance(method, ISMethod) else ISMethod(method.lower())
    except ValueError:
        valid_methods = ", ".join(m.value for m in ISMethod)
        raise ValueError(f"Invalid method '{method}'. Must be one of: {valid_methods}")
    if method != ISMethod.PSIS:
        _warn_non_psis(method)

    matrix, _, _ = as_sample_matrix(log_likelihood)  # (n_obs, S) on the device
    matrix = clean_log_likelihood(matrix, context="LOO")

    log_p, log_q, indices = _validated_resample_indices(
        log_p, log_q, method=resample_method, seed=seed
    )
    if indices is not None:
        matrix = matrix.index_select(1, torch.as_tensor(indices, dtype=torch.int64,
                                                        device=matrix.device))

    if method == ISMethod.PSIS:
        m_tail = tail_length(n_samples, reff)
        scores = apply_rowwise(lambda b: loo_scores_psis(b, m_tail), matrix)
    elif method == ISMethod.SIS:
        scores = apply_rowwise(loo_scores_sis, matrix)
    else:
        scores = apply_rowwise(loo_scores_tis, matrix)
    del matrix
    elpd_i, diag, lppd_i = map(_host, scores)

    warn_mg = False
    good_k = good_k_threshold(n_samples)
    if method == ISMethod.PSIS:
        if np.any(diag > good_k):
            n_high_k = int(np.sum(diag > good_k))
            warnings.warn(
                "Estimated shape parameter of Pareto distribution is greater than"
                f" {good_k:.2f} for {n_high_k} observations. This indicates that"
                " importance sampling may be unreliable because the marginal posterior"
                " and LOO posterior are very different.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True
    else:
        min_ess = float(np.min(diag))
        if min_ess < n_samples * 0.1:
            warnings.warn(
                f"Low effective sample size detected (minimum ESS: {min_ess:.1f}). This"
                " indicates that the importance sampling approximation may be"
                " unreliable. Consider using PSIS which is more robust to such cases.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True

    obs_dims = tuple(d for d in log_likelihood.dims if d != "__sample__")
    obs_coords = {d: c for d, c in log_likelihood.coords.items() if d in obs_dims}
    obs_shape = tuple(log_likelihood.sizes[d] for d in obs_dims)

    loo_lppd_i = DataArray(
        scale_value * elpd_i.reshape(obs_shape), obs_dims, obs_coords, "loo_i"
    )
    diagnostic = DataArray(
        diag.reshape(obs_shape), obs_dims, obs_coords,
        "pareto_k" if method == ISMethod.PSIS else "ess",
    )

    loo_lppd = float(loo_lppd_i.values.sum())
    loo_lppd_se = float((n_data_points * np.var(loo_lppd_i.values)) ** 0.5)
    lppd = float(np.sum(lppd_i))
    p_loo = lppd - loo_lppd / scale_value
    p_loo_se = float(np.sqrt(np.sum(np.var(loo_lppd_i.values))))
    looic = -2 * loo_lppd
    looic_se = 2 * loo_lppd_se

    rows: list[tuple[str, Any]] = [
        ("elpd_loo", loo_lppd),
        ("se", loo_lppd_se),
        ("p_loo", p_loo),
        ("p_loo_se", p_loo_se),
        ("n_samples", n_samples),
        ("n_data_points", n_data_points),
        ("warning", warn_mg),
    ]
    if pointwise:
        if np.allclose(loo_lppd_i.values, loo_lppd_i.values.flat[0]):
            warnings.warn(
                "The point-wise LOO is the same with the sum LOO, please double check "
                "the Observed RV in your model to make sure it returns element-wise"
                " logp.",
                stacklevel=2,
            )
        rows.append(("loo_i", loo_lppd_i))
    rows += [("scale", scale), ("looic", looic), ("looic_se", looic_se)]
    if pointwise:
        if method == ISMethod.PSIS:
            rows += [("pareto_k", diagnostic), ("good_k", good_k)]
        else:
            rows += [("ess", diagnostic)]
    elif method == ISMethod.PSIS:
        rows += [("good_k", good_k)]

    result = ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
    result.approximate_posterior = {"log_p": log_p, "log_q": log_q}
    return result


def _warn_non_psis(method: ISMethod) -> None:
    """Shared warning for non-PSIS LOO (reference loo_approximate_posterior.py:74-80)."""
    warnings.warn(
        f"Using {method.value.upper()} for LOO computation. Note that PSIS is the"
        " recommended method as it is typically more efficient and reliable.",
        UserWarning,
        stacklevel=3,
    )


def _validated_resample_indices(
    log_p,
    log_q,
    method: str = "psis",
    seed: int | None = None,
    n_draws: int | None = None,
):
    """Validate log_p/log_q and draw resample indices with the shared
    failure fallback (reference ``loo_approximate_posterior.py:58-96``).

    Returns ``(log_p, log_q, indices)`` with ``indices=None`` when the
    resample failed (a warning is emitted and callers fall back to the
    original draws).  Used by both the in-memory and the streaming path so
    the two cannot drift.
    """
    log_p = np.asarray(log_p).ravel()
    log_q = np.asarray(log_q).ravel()
    if len(log_p) != len(log_q):
        raise ValueError(
            f"log_p and log_q must have the same length, got {len(log_p)} and"
            f" {len(log_q)}"
        )
    if n_draws is not None and len(log_p) != n_draws:
        raise ValueError(f"log_p/log_q length ({len(log_p)}) must match n_draws ({n_draws})")
    try:
        indices = importance_resample(log_p=log_p, log_q=log_q, method=method, seed=seed)
    except Exception as e:
        warnings.warn(
            f"Importance resampling failed: {str(e)}. Falling back to original samples.",
            UserWarning,
            stacklevel=3,
        )
        indices = None
    return log_p, log_q, indices


def importance_resample(
    log_p: np.ndarray,
    log_q: np.ndarray,
    method: str = "psis",
    seed: int | None = None,
) -> np.ndarray:
    """Resample draw indices by target/proposal importance weights.

    ``psis`` smooths (:func:`pyloo_tpu_torch.psislw`, on the device) then
    samples without replacement, ``psir`` with replacement, ``sis``
    normalizes without smoothing.  The draw comes from numpy's
    ``RandomState(seed)`` on the host.  Degenerate-weight fallbacks mirror
    reference ``loo_approximate_posterior.py:437-534``.
    """
    compute_device()  # the smoothing runs there: never a quiet host fallback
    rng = np.random.RandomState(seed) if seed is not None else np.random.RandomState()
    log_p = np.asarray(log_p).ravel()
    log_q = np.asarray(log_q).ravel()
    draws = len(log_p)
    logiw = log_p - log_q

    valid_mask = np.isfinite(logiw)
    if not np.all(valid_mask):
        warnings.warn(
            f"Found {np.sum(~valid_mask)} non-finite importance weights. These will be"
            " excluded.",
            UserWarning,
            stacklevel=2,
        )
        if np.sum(valid_mask) == 0:
            raise ValueError("No valid importance weights found.")
        logiw = logiw[valid_mask]
        orig_indices = np.nonzero(valid_mask)[0]
    else:
        orig_indices = None

    replace = method == "psir"
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", category=RuntimeWarning, message="overflow encountered in exp"
        )
        if method in ("psis", "psir"):
            try:
                logiw_smoothed, _ = psislw(logiw)
                logiw = np.asarray(logiw_smoothed)
            except Exception as e:
                warnings.warn(f"PSIS smoothing failed: {str(e)}.", UserWarning, stacklevel=2)
        else:
            logiw = logiw - _logsumexp(logiw)

    p = np.exp(logiw)
    p = p / np.sum(p)
    pool = len(p)

    try:
        chosen = rng.choice(pool, size=draws, replace=replace, p=p)
    except ValueError as e:
        if "Fewer non-zero entries in p than size" in str(e) and not replace:
            warnings.warn(
                "Not enough non-zero weights for sampling without replacement. "
                "Switching to sampling with replacement.",
                UserWarning,
                stacklevel=2,
            )
            chosen = rng.choice(pool, size=draws, replace=True, p=p)
        else:
            warnings.warn(
                f"Resampling failed: {str(e)}. Using random indices.",
                UserWarning,
                stacklevel=2,
            )
            chosen = rng.choice(pool, size=draws)

    if orig_indices is not None:
        return orig_indices[chosen]
    return chosen
