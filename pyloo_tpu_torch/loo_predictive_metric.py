"""LOO predictive point metrics (MAE / MSE / RMSE / accuracy / balanced acc).

Counterpart of ``pyloo_tpu/loo_predictive_metric.py`` (reference
``pyloo/loo_predictive_metric.py:22-372``): the LOO predictive mean comes
from :func:`pyloo_tpu_torch.e_loo` under PSIS weights, both on the device;
the metric and its SE are closed-form host arithmetic.
"""

from __future__ import annotations

from typing import Literal, TypedDict

import numpy as np

from .e_loo import e_loo
from .psis import psislw
from .utils import to_inference_data

__all__ = ["loo_predictive_metric", "MetricResult"]


class MetricResult(TypedDict):
    """Point estimate and standard error of a predictive metric."""

    estimate: float
    se: float


def loo_predictive_metric(
    data,
    y: np.ndarray,
    var_name: str | None = None,
    group: str = "posterior_predictive",
    log_lik_group: str = "log_likelihood",
    log_lik_var_name: str | None = None,
    metric: Literal["mae", "mse", "rmse", "acc", "balanced_acc"] = "mae",
    r_eff: float = 1.0,
    **kwargs,
) -> MetricResult:
    """LOO-CV estimate of a predictive point metric.

    Computes the PSIS-weighted leave-one-out predictive mean of the
    posterior-predictive samples and scores it against ``y``.  Binary metrics
    ("acc", "balanced_acc") expect probabilities/0-1 outcomes.
    """
    y = np.asarray(y).flatten()
    idata = to_inference_data(data)

    if not hasattr(idata, group):
        raise ValueError(f"InferenceData object does not have a {group} group")
    if not hasattr(idata, log_lik_group):
        raise ValueError(
            f"InferenceData object does not have a {log_lik_group} group"
        )

    ll_group = getattr(idata, log_lik_group)
    if log_lik_var_name is None:
        ll_var_names = list(ll_group.data_vars)
        if len(ll_var_names) == 1:
            log_lik_var_name = ll_var_names[0]
        else:
            raise ValueError(
                f"Multiple variables found in {log_lik_group} group. Please specify"
                f" log_lik_var_name from: {ll_var_names}"
            )
    elif log_lik_var_name not in ll_group.data_vars:
        raise ValueError(
            f"Variable '{log_lik_var_name}' not found in {log_lik_group} group."
            f" Available variables: {list(ll_group.data_vars)}"
        )

    log_lik = ll_group[log_lik_var_name]
    if "chain" in log_lik.dims and "draw" in log_lik.dims:
        log_lik = log_lik.stack(__sample__=("chain", "draw"))

    n_obs = int(
        np.prod([s for d, s in log_lik.sizes.items() if d != "__sample__"])
    )
    if len(y) != n_obs:
        raise ValueError(
            f"Length of y ({len(y)}) must match the number of observations in x"
            f" ({n_obs})"
        )

    if metric not in ["mae", "mse", "rmse", "acc", "balanced_acc"]:
        raise ValueError(
            f"Invalid metric: {metric}. Must be one of: 'mae', 'mse', 'rmse', 'acc',"
            " 'balanced_acc'"
        )

    log_weights, _ = psislw(-log_lik, reff=r_eff)
    loo_result = e_loo(
        idata,
        var_name=var_name,
        group=group,
        log_weights=log_weights,
        log_ratios=-log_lik,
        type="mean",
        **kwargs,
    )
    pred_loo = np.asarray(
        loo_result.value.values
        if hasattr(loo_result.value, "values")
        else loo_result.value
    ).ravel()

    scorer = {
        "mae": _mae,
        "mse": _mse,
        "rmse": _rmse,
        "acc": _accuracy,
        "balanced_acc": _balanced_accuracy,
    }[metric]
    return scorer(y, pred_loo)


def _check_lengths(y, yhat) -> int:
    if len(y) != len(yhat):
        raise ValueError("y and yhat must have the same length")
    return len(y)


def _check_binary(y, yhat) -> None:
    if not np.all((y <= 1) & (y >= 0)):
        raise ValueError("y must contain values between 0 and 1")
    if not np.all((yhat <= 1) & (yhat >= 0)):
        raise ValueError("yhat must contain values between 0 and 1")


def _mae(y, yhat) -> MetricResult:
    """Mean absolute error with SE = sd(|e|)/sqrt(n)."""
    n = _check_lengths(y, yhat)
    e = np.abs(y - yhat)
    return {"estimate": float(np.mean(e)), "se": float(np.std(e, ddof=1) / np.sqrt(n))}


def _mse(y, yhat) -> MetricResult:
    """Mean squared error with SE = sd(e^2)/sqrt(n)."""
    n = _check_lengths(y, yhat)
    e = (y - yhat) ** 2
    return {"estimate": float(np.mean(e)), "se": float(np.std(e, ddof=1) / np.sqrt(n))}


def _rmse(y, yhat) -> MetricResult:
    """Root MSE; SE by first-order delta method."""
    mse = _mse(y, yhat)
    var_rmse = mse["se"] ** 2 / mse["estimate"] / 4
    return {"estimate": float(np.sqrt(mse["estimate"])), "se": float(np.sqrt(var_rmse))}


def _accuracy(y, yhat) -> MetricResult:
    """Proportion of correct 0.5-thresholded predictions."""
    n = _check_lengths(y, yhat)
    _check_binary(y, yhat)
    correct = ((yhat > 0.5).astype(int) == y).astype(int)
    est = float(np.mean(correct))
    return {"estimate": est, "se": float(np.sqrt(est * (1 - est) / n))}


def _balanced_accuracy(y, yhat) -> MetricResult:
    """Mean of true-positive and true-negative rates."""
    n = _check_lengths(y, yhat)
    _check_binary(y, yhat)
    yhat_binary = (yhat > 0.5).astype(int)
    mask = y == 0
    tn = np.mean(yhat_binary[mask] == y[mask])
    tp = np.mean(yhat_binary[~mask] == y[~mask])
    bls_acc = (tp + tn) / 2
    bls_acc_var = (tp * (1 - tp) + tn * (1 - tn)) / 4
    return {"estimate": float(bls_acc), "se": float(np.sqrt(bls_acc_var / n))}
