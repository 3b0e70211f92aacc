"""Weighted expectations under importance-sampling weights.

Counterpart of ``pyloo_tpu/e_loo.py`` (reference ``pyloo/e_loo.py:56-559``):
weighted mean/variance/sd/quantile of posterior(-predictive) samples under
PSIS weights, with the function-specific Pareto-k diagnostic, minimum sample
size, k-hat threshold, and convergence rate.  The per-observation numerics
(:mod:`pyloo_tpu_torch.ops.expectations`) run on the device in row chunks.

Note: the reference's ``k_hat`` (e_loo.py:350-357) feeds a descending tail
containing an exact zero into the GPD fit, and the r-tail diagnostic always
returns the prior constant ``5/(tail_len+10)``.  Like ``pyloo_tpu``, this
computes the intended diagnostic (exceedances over the (tail_len+1)-th order
statistic, ascending).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from .base import _host, as_sample_matrix
from .containers import DataArray
from .ops.expectations import (
    khat_batch,
    weighted_mean_batch,
    weighted_quantile_batch,
    weighted_variance_batch,
)
from .parallel import apply_rowwise
from .utils import to_inference_data

__all__ = [
    "e_loo",
    "ExpectationResult",
    "compute_pareto_k",
    "k_hat",
    "_pareto_min_ss",
    "_pareto_khat_threshold",
    "_pareto_convergence_rate",
]

# full-width (chunk, S) buffers beyond the scorers' four: the quantile's
# stable argsort (int64 indices, the sorted values and weights and their
# cumulative sum); the k-hat's ratios, h * r and its negation
_QUANTILE_EXTRA_BUFFERS = 6
_KHAT_EXTRA_BUFFERS = 2


@dataclass
class ExpectationResult:
    """Results of a weighted expectation.

    ``value`` carries the expectation (quantile outputs gain a trailing
    ``quantile`` dimension); ``pareto_k`` the function-specific diagnostic;
    ``min_ss`` / ``khat_threshold`` / ``convergence_rate`` the reliability
    measures of Vehtari et al. (2024) §4.
    """

    value: Any
    pareto_k: Any
    min_ss: Any = None
    khat_threshold: Any = None
    convergence_rate: Any = None


def _as_matrix_pair(x_da, lw_da):
    """Align h(theta) samples and log-weights into matching (B, S) tensors.

    A per-draw quantity without observation dimensions (e.g. a scalar
    posterior parameter) broadcasts across the weights' observation axis,
    mirroring the reference's xarray broadcasting (e_loo.py:429-436): the
    result is then h's expectation under each observation's LOO weights.
    """
    x_matrix, S_x, x_rebuild = as_sample_matrix(x_da)
    lw_matrix, S_w, lw_rebuild = as_sample_matrix(lw_da)
    if S_x != S_w:
        raise ValueError(f"x has {S_x} draws but log_weights has {S_w}")
    if x_matrix.shape != lw_matrix.shape:
        if x_matrix.shape[0] == 1:
            return x_matrix.expand(lw_matrix.shape), lw_matrix, lw_rebuild
        raise ValueError(
            f"x {tuple(x_matrix.shape)} and log_weights {tuple(lw_matrix.shape)} must have"
            " the same shape (or x must have no observation dimensions)"
        )
    return x_matrix, lw_matrix, x_rebuild


def _khat_rows(h, log_ratios, tail_len: int = 20, squared: bool = False):
    """``khat_batch`` over row chunks; ``h`` None fits the ratios alone."""
    if h is None:
        (k,) = apply_rowwise(
            lambda lr: (khat_batch(lr, lr, tail_len=tail_len, use_h=False),),
            log_ratios,
            extra_buffers=_KHAT_EXTRA_BUFFERS,
        )
    else:
        (k,) = apply_rowwise(
            lambda x, lr: (khat_batch(x**2 if squared else x, lr, tail_len=tail_len),),
            (h, log_ratios),
            extra_buffers=_KHAT_EXTRA_BUFFERS,
        )
    return _host(k)


def e_loo(
    data,
    var_name: str | None = None,
    group: str = "posterior_predictive",
    weights=None,
    log_weights=None,
    log_ratios=None,
    type: str = "mean",
    probs: float | Sequence[float] | None = None,
) -> ExpectationResult:
    """Compute weighted expectations of posterior(-predictive) samples.

    Parameters
    ----------
    data : InferenceData, DataArray, or convertible
        Samples of h(theta); ``var_name``/``group`` select the variable when
        an InferenceData is given.
    weights, log_weights : DataArray or array
        Importance sampling weights (one of the two required), typically the
        smoothed weights from :func:`pyloo_tpu_torch.psislw`.
    log_ratios : optional
        Raw (unsmoothed) log ratios for sharper Pareto-k diagnostics.
    type : {"mean", "variance", "sd", "quantile"}
    probs : float or sequence, required for quantiles.

    Examples
    --------
    .. code-block:: python

        import pyloo_tpu_torch as pl

        idata = pl.load_example_data("centered_eight")
        ll = idata.log_likelihood.obs.stack(__sample__=("chain", "draw"))
        lw, k = pl.psislw(-ll)
        means = pl.e_loo(idata, group="posterior", var_name="theta",
                         log_weights=lw, log_ratios=-ll)
        means.value              # LOO-weighted posterior means
        means.pareto_k           # function-specific reliability diagnostic
    """
    if type not in ["mean", "variance", "sd", "quantile"]:
        raise ValueError("type must be 'mean', 'variance', 'sd' or 'quantile'")

    probs_array = None
    if type == "quantile":
        if probs is None:
            raise ValueError("probs must be provided for quantile calculation")
        probs_array = np.atleast_1d(np.asarray(probs, dtype=np.float64))
        if not np.all((probs_array > 0) & (probs_array < 1)):
            raise ValueError("probs must be between 0 and 1")

    if weights is None and log_weights is None:
        raise ValueError("Either weights or log_weights must be provided")

    if isinstance(data, DataArray):
        x_data = data
    else:
        idata = to_inference_data(data)
        if not hasattr(idata, group):
            raise ValueError(f"InferenceData object does not have a {group} group")
        data_group = getattr(idata, group)
        if var_name is None:
            var_names = list(data_group.data_vars)
            if len(var_names) == 1:
                var_name = var_names[0]
            else:
                raise ValueError(
                    f"Multiple variables found in {group} group. Please specify"
                    f" var_name from: {var_names}"
                )
        elif var_name not in data_group.data_vars:
            raise ValueError(
                f"Variable '{var_name}' not found in {group} group. Available"
                f" variables: {list(data_group.data_vars)}"
            )
        x_data = data_group[var_name]

    if "chain" in x_data.dims and "draw" in x_data.dims:
        x_data = x_data.stack(__sample__=("chain", "draw"))

    if weights is not None:
        w_values = weights.values if isinstance(weights, DataArray) else np.asarray(weights)
        log_w = np.log(w_values)
        log_weights = (
            DataArray(log_w, weights.dims, dict(weights.coords))
            if isinstance(weights, DataArray)
            else log_w
        )

    if isinstance(log_weights, DataArray) and "__sample__" not in log_weights.dims:
        if "chain" in log_weights.dims and "draw" in log_weights.dims:
            log_weights = log_weights.stack(__sample__=("chain", "draw"))
        else:
            new_dims = log_weights.dims[:-1] + ("__sample__",)
            log_weights = DataArray(
                log_weights.values, new_dims,
                {d: c for d, c in log_weights.coords.items() if d in new_dims[:-1]},
            )

    if not isinstance(log_weights, DataArray):
        log_weights = DataArray(
            np.asarray(log_weights),
            x_data.dims if np.asarray(log_weights).ndim == x_data.ndim else None,
        )

    x_matrix, lw_matrix, rebuild = _as_matrix_pair(x_data, log_weights)
    n_samples = x_matrix.shape[1]

    if type == "mean":
        (value,) = apply_rowwise(
            lambda x, lw: (weighted_mean_batch(x, lw),), (x_matrix, lw_matrix)
        )
    elif type in ("variance", "sd"):
        (value,) = apply_rowwise(
            lambda x, lw: (weighted_variance_batch(x, lw),), (x_matrix, lw_matrix)
        )
        if type == "sd":
            value = torch.sqrt(value)
    else:
        (value,) = apply_rowwise(
            lambda x, lw: (weighted_quantile_batch(x, lw, probs_array),),
            (x_matrix, lw_matrix),
            extra_buffers=_QUANTILE_EXTRA_BUFFERS,
        )  # (B, n_probs)
    value_flat = _host(value)

    # diagnostics ---------------------------------------------------------
    if log_ratios is not None:
        del lw_matrix
        lr_matrix, _, _ = as_sample_matrix(
            log_ratios
            if isinstance(log_ratios, DataArray)
            else DataArray(np.asarray(log_ratios))
        )
    else:
        lr_matrix = lw_matrix

    if type == "quantile":
        k_flat = _khat_rows(None, lr_matrix)
    else:
        k_flat = _khat_rows(x_matrix, lr_matrix, squared=type in ("variance", "sd"))
    del x_matrix, lr_matrix

    min_ss_flat = _min_ss_vectorized(k_flat)
    khat_thresh = _pareto_khat_threshold(n_samples)
    conv_flat = _convergence_rate_vectorized(k_flat, n_samples)

    # reshape back to labeled observation dims -----------------------------
    _, k_da = rebuild(None, k_flat)
    _, min_ss_da = rebuild(None, min_ss_flat)
    _, conv_da = rebuild(None, conv_flat)
    if isinstance(k_da, DataArray):
        k_da = k_da.rename("pareto_k")

    if type == "quantile":
        if isinstance(k_da, DataArray):
            value = DataArray(
                value_flat.reshape(k_da.shape + (len(probs_array),)),
                k_da.dims + ("quantile",),
                {**k_da.coords, "quantile": probs_array},
            )
        else:
            value = value_flat.reshape(np.shape(k_da) + (len(probs_array),))
    else:
        _, value = rebuild(None, value_flat)

    threshold = (
        DataArray(np.full(k_da.shape, khat_thresh), k_da.dims, dict(k_da.coords))
        if isinstance(k_da, DataArray)
        else np.full(np.shape(k_da) or (), khat_thresh)
    )

    return ExpectationResult(
        value=value,
        pareto_k=k_da,
        min_ss=min_ss_da,
        khat_threshold=threshold,
        convergence_rate=conv_da,
    )


def compute_pareto_k(x, log_ratios, tail_len: int = 20):
    """Pareto k diagnostic for expectation estimates (batched).

    ``x`` holds h(theta) values (None for quantile estimates); ``log_ratios``
    the raw log importance ratios.
    """
    if tail_len < 5:
        raise ValueError("tail_len must be at least 5")
    if isinstance(log_ratios, DataArray):
        lr_matrix, _, rebuild = as_sample_matrix(log_ratios)
        x_matrix = None
        if x is not None:
            x_matrix, _, _ = as_sample_matrix(
                x if isinstance(x, DataArray) else DataArray(np.asarray(x))
            )
        _, k_da = rebuild(None, _khat_rows(x_matrix, lr_matrix, tail_len))
        return k_da.rename("pareto_k") if isinstance(k_da, DataArray) else k_da

    lr = np.atleast_2d(np.asarray(log_ratios))
    xx = None
    if x is not None:
        xx = np.atleast_2d(np.asarray(x))
        if xx.shape != lr.shape:
            raise ValueError("x and log_ratios must have the same shape")
        xx = as_sample_matrix(xx)[0]
    k = _khat_rows(xx, as_sample_matrix(lr)[0], tail_len)
    return float(k[0]) if np.asarray(log_ratios).ndim == 1 else k


def k_hat(x_vals, log_ratios_vals, tail_len: int = 20) -> float:
    """Scalar-path Pareto k for one observation (reference e_loo.py:328-390)."""
    lr = as_sample_matrix(np.asarray(log_ratios_vals)[None, :])[0]
    x = None if x_vals is None else as_sample_matrix(np.asarray(x_vals)[None, :])[0]
    return float(_khat_rows(x, lr, tail_len)[0])


def _pareto_min_ss(k: float) -> float:
    """Minimum sample size for a reliable Pareto-smoothed estimate."""
    if np.isnan(k):
        return float("inf")
    if k < 1:
        return 10 ** (1 / (1 - max(0, k)))
    return float("inf")


def _min_ss_vectorized(k):
    """:func:`_pareto_min_ss` over a k vector (``pyloo_tpu/streaming.py:1256``)."""
    k = np.asarray(k, dtype=np.float64)
    out = np.full(k.shape, np.inf)
    m = ~np.isnan(k) & (k < 1)
    with np.errstate(over="ignore"):  # k just below 1: the minimum is inf
        out[m] = 10.0 ** (1.0 / (1.0 - np.maximum(0.0, k[m])))
    return out


def _convergence_rate_vectorized(k, n_samples):
    """:func:`_pareto_convergence_rate` over a k vector (``pyloo_tpu/streaming.py:1264``).

    Piecewise: NaN -> 0, k < 0 -> 1, k > 1 -> 0, k == 1/2 -> 1 - 1/log(n),
    0 < k < 1 -> the finite-n rate clamped at 0, else (k in {0, 1}) -> 1.
    """
    k = np.asarray(k, dtype=np.float64)
    n = float(n_samples)
    out = np.ones(k.shape)
    out[np.isnan(k)] = 0.0
    out[k > 1] = 0.0
    half = k == 0.5
    out[half] = 1.0 - 1.0 / np.log(n)
    mid = (k > 0) & (k < 1) & ~half
    km = k[mid]
    num = (
        2.0 * (km - 1.0) * n ** (2.0 * km + 1.0)
        + (1.0 - 2.0 * km) * n ** (2.0 * km)
        + n**2
    )
    den = (n - 1.0) * (n - n ** (2.0 * km))
    out[mid] = np.maximum(0.0, num / den)
    return out


def _pareto_khat_threshold(n_samples: int) -> float:
    """k-hat threshold 1 - 1/log10(S) for reliable estimates."""
    return 1 - 1 / np.log10(n_samples)


def _pareto_convergence_rate(k: float, n_samples: int) -> float:
    """Relative convergence rate vs the CLT for a Pareto-smoothed estimate."""
    if np.isnan(k):
        return 0.0
    if k < 0:
        return 1.0
    if k > 1:
        return 0.0
    if k == 0.5:
        return 1 - 1 / np.log(n_samples)
    if 0 < k < 1:
        n = n_samples
        return max(
            0,
            (2 * (k - 1) * n ** (2 * k + 1) + (1 - 2 * k) * n ** (2 * k) + n**2)
            / ((n - 1) * (n - n ** (2 * k))),
        )
    return 1.0
