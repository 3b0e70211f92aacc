"""LOO-CV for a single observation.

Counterpart of ``pyloo_tpu/loo_i.py`` (reference ``pyloo/loo_i.py:16-294``):
the LOO pipeline on one row of the log-likelihood matrix, with a
delta-method SE on the importance-sampling estimate.  Only that row goes to
the device.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np

from ._common import clean_log_likelihood, compute_reff, good_k_threshold, resolve_scale
from .base import ISMethod, _host, as_sample_matrix, compute_importance_weights
from .containers import DataArray
from .elpd import ELPDData
from .rcparams import rcParams
from .utils import _logsumexp, get_log_likelihood, to_inference_data

__all__ = ["loo_i"]


def _obs_row(log_likelihood: DataArray, i: int) -> np.ndarray:
    """Draws of observation ``i`` (flat index over the obs dims) of a
    ``(*obs, __sample__)`` array, as ``(1, S)``, without laying out the
    whole obs-major matrix on the host."""
    lazy = log_likelihood._lazy
    if lazy is not None:
        base, order, n_collapse = lazy
        v = base.transpose(order)
        obs_shape = v.shape[: v.ndim - n_collapse]
        return v[np.unravel_index(i, obs_shape)].reshape(1, -1)
    values = log_likelihood.values
    return values.reshape(-1, values.shape[-1])[i : i + 1]


def loo_i(
    i: int,
    data,
    pointwise: bool | None = None,
    var_name: str | None = None,
    reff: float | None = None,
    scale: str | None = None,
    method="psis",
) -> ELPDData:
    """Compute LOO for observation ``i`` only (flat index over obs dims)."""
    inference_data = to_inference_data(data)
    log_likelihood = get_log_likelihood(inference_data, var_name=var_name)
    pointwise = rcParams["stats.ic_pointwise"] if pointwise is None else pointwise

    log_likelihood = log_likelihood.stack(__sample__=("chain", "draw"))
    shape = log_likelihood.shape
    n_samples = shape[-1]
    n_data_points = 1

    if isinstance(i, (list, tuple, np.ndarray)):
        raise ValueError("loo_i only accepts a single integer index")
    try:
        i = int(i)
    except (TypeError, ValueError):
        raise TypeError("Index i must be an integer")

    total_obs = int(np.prod(shape[:-1]))
    if i >= total_obs or i < 0:
        raise IndexError(
            f"Index {i} is out of bounds for log likelihood array with"
            f" {total_obs} observations"
        )

    scale, scale_value = resolve_scale(scale)
    reff = compute_reff(inference_data, reff, n_samples)
    row, _, _ = as_sample_matrix(_obs_row(log_likelihood, i))
    row = clean_log_likelihood(row, context="LOO")
    ll_i = DataArray(_host(row), ("obs", "__sample__"))

    try:
        method = method if isinstance(method, ISMethod) else ISMethod(method.lower())
    except ValueError:
        valid_methods = ", ".join(m.value for m in ISMethod)
        raise ValueError(f"Invalid method '{method}'. Must be one of: {valid_methods}")
    if method != ISMethod.PSIS:
        warnings.warn(
            f"Using {method.value.upper()} for LOO computation. Note that PSIS is the"
            " recommended method as it is typically more efficient and reliable.",
            UserWarning,
            stacklevel=2,
        )

    log_weights, diagnostic = compute_importance_weights(-ll_i, method=method, reff=reff)
    log_weights = log_weights + ll_i

    warn_mg = False
    good_k = good_k_threshold(n_samples)
    diag_values = np.atleast_1d(
        diagnostic.values if isinstance(diagnostic, DataArray) else diagnostic
    )
    if method == ISMethod.PSIS:
        if np.any(diag_values > good_k):
            warnings.warn(
                "Estimated shape parameter of Pareto distribution is greater than"
                f" {good_k:.2f} for 1 observations. This indicates that"
                " importance sampling may be unreliable because the marginal"
                " posterior and LOO posterior are very different.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True
    else:
        min_ess = float(np.min(diag_values))
        if min_ess < n_samples * 0.1:
            warnings.warn(
                f"Low effective sample size detected (minimum ESS: {min_ess:.1f}). This"
                " indicates that the importance sampling approximation may be"
                " unreliable. Consider using PSIS which is more robust to such cases.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True

    lw = log_weights.values
    loo_lppd_i = DataArray(
        scale_value * np.atleast_1d(_logsumexp(lw, axis=-1)), ("obs",), name="loo_i"
    )
    loo_lppd = float(loo_lppd_i.values.sum())

    # delta-method SE of the single-observation IS estimate (loo_i.py:226-235)
    weights = np.exp(lw - np.max(lw, axis=-1, keepdims=True))
    weights /= np.sum(weights, axis=-1, keepdims=True)
    lik = np.exp(ll_i.values)
    E_epd = np.exp(loo_lppd)
    var_epd = np.sum(weights**2 * (lik - E_epd) ** 2) / reff
    # E_epd underflows to 0 when the scaled elpd is very negative (e.g. a
    # NaN-replaced -1e10 likelihood); the SE is then unbounded, not 0/0
    if E_epd > 0:
        loo_lppd_se = float(np.sqrt(np.log1p(var_epd / E_epd**2)))
    else:
        loo_lppd_se = float("inf")

    lppd = float(np.sum(_logsumexp(ll_i.values, b_inv=n_samples, axis=-1)))
    p_loo = lppd - loo_lppd / scale_value

    rows: list[tuple[str, Any]] = [
        ("elpd_loo", loo_lppd),
        ("se", loo_lppd_se),
        ("p_loo", p_loo),
        ("n_samples", n_samples),
        ("n_data_points", n_data_points),
        ("warning", warn_mg),
    ]
    if pointwise:
        rows.append(("loo_i", loo_lppd_i))
    rows.append(("scale", scale))
    if pointwise:
        if method == ISMethod.PSIS:
            rows += [("pareto_k", diag_values), ("good_k", good_k)]
        else:
            rows += [("ess", diag_values)]
    elif method == ISMethod.PSIS:
        rows += [("good_k", good_k)]

    return ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
