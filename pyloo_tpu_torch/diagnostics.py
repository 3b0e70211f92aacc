"""PSIS diagnostic helpers and LOO-PIT calibration.

Counterpart of ``pyloo_tpu/diagnostics.py``: R ``loo``-ecosystem parity
beyond the reference package (the reference exposes Pareto k only inside
result objects and print templates):

* :func:`pareto_k_values` / :func:`pareto_k_ids` / :func:`pareto_k_table` -
  accessors over a pointwise :class:`~pyloo_tpu_torch.elpd.ELPDData`.
* :func:`psis_ess_values`: per-observation importance-sampling effective
  sample size ``1 / sum(w^2)`` under the smoothed LOO weights.
* :func:`mcse_loo`: Monte-Carlo standard error of ``elpd_loo`` via the
  delta-method self-normalized-IS variance estimator.
* :func:`loo_pit`: LOO probability integral transform for calibration
  checking (weighted predictive CDF evaluated at each observation).

The weight-bearing functions smooth the weights (:func:`psislw_batch`) and
reduce them chunk of rows by chunk of rows on the device: the ``(n_obs, S)``
weight matrix is never held whole, and only per-observation vectors come
back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ._common import clean_log_likelihood, compute_reff
from .base import _WEIGHTS_EXTRA_BUFFERS, _host, as_sample_matrix
from .containers import DataArray
from .ops import psislw_batch, tail_length
from .ops.lse import logsumexp
from .parallel import apply_rowwise
from .utils import get_log_likelihood, to_inference_data

__all__ = [
    "pareto_k_values",
    "pareto_k_ids",
    "pareto_k_table",
    "psis_ess_values",
    "mcse_loo",
    "loo_pit",
    "relative_eff",
]


def _k_array(elpd_data):
    if "pareto_k" not in elpd_data:
        raise ValueError(
            "result carries no pointwise Pareto k values; recompute with "
            "pointwise=True and method='psis'"
        )
    k = elpd_data["pareto_k"]
    return np.asarray(getattr(k, "values", k)).ravel()


def pareto_k_values(elpd_data):
    """Pointwise Pareto k̂ values from a pointwise PSIS result."""
    return _k_array(elpd_data)


def pareto_k_ids(elpd_data, threshold: float | None = None):
    """Indices of observations whose k̂ exceeds ``threshold``.

    ``threshold`` defaults to the result's ``good_k``
    (``min(1 - 1/log10(S), 0.7)``).
    """
    k = _k_array(elpd_data)
    if threshold is None:
        threshold = elpd_data.get("good_k", None) or 0.7
    return np.nonzero(k > threshold)[0]


@dataclass(frozen=True)
class ParetoKTable:
    """Counts/proportions of k̂ per reliability bin (printable)."""

    bins: tuple
    counts: np.ndarray
    proportions: np.ndarray
    threshold: float

    def __str__(self):
        labels = [
            f"(-Inf, {self.threshold:.2g}]  (good)",
            f"({self.threshold:.2g}, 1]  (bad)",
            "(1, Inf)  (very bad)",
        ]
        lines = ["Pareto k diagnostic values:",
                 f"{'':>24} {'Count':>6} {'Pct.':>7}"]
        for lab, c, p in zip(labels, self.counts, self.proportions):
            lines.append(f"{lab:>24} {c:>6d} {p:>6.1%}")
        return "\n".join(lines)


def pareto_k_table(elpd_data, threshold: float | None = None) -> ParetoKTable:
    """Tabulate k̂ into good / bad / very-bad bins (R ``pareto_k_table``)."""
    k = _k_array(elpd_data)
    if threshold is None:
        threshold = elpd_data.get("good_k", None) or 0.7
    counts = np.array(
        [
            int(np.sum(k <= threshold)),
            int(np.sum((k > threshold) & (k <= 1))),
            int(np.sum(k > 1)),
        ]
    )
    return ParetoKTable(
        bins=(-np.inf, threshold, 1.0, np.inf),
        counts=counts,
        proportions=counts / max(len(k), 1),
        threshold=float(threshold),
    )


def _reduce_loo_weights(data, var_name, reff, reduce, *others):
    """Smooth the LOO weights of every observation and reduce them by rows.

    ``reduce(ll, lw, k, *others)`` takes one chunk of the ``(N, S)``
    log-likelihood, its smoothed log-weights (PSIS on ``-log_lik``, the
    weights :func:`pyloo_tpu_torch.loo` uses), their k and the same rows of
    the tensors that each of ``others`` makes from the device matrix, and
    returns per-row outputs.  Returns those outputs for all rows, on the host.
    """
    inference_data = to_inference_data(data)
    ll_da = get_log_likelihood(inference_data, var_name=var_name)
    ll_da = ll_da.stack(__sample__=("chain", "draw"))
    matrix, n_samples, _ = as_sample_matrix(ll_da)
    matrix = clean_log_likelihood(matrix, context="LOO")
    m_tail = tail_length(n_samples, compute_reff(inference_data, reff, n_samples))
    extra = tuple(make(matrix) for make in others)

    def kernel(ll, *rest):
        lw, k = psislw_batch(-ll, m_tail)
        return reduce(ll, lw, k, *rest)

    # the weights of a chunk and the product a reduction makes of them
    return tuple(
        map(
            _host,
            apply_rowwise(
                kernel, (matrix,) + extra, extra_buffers=_WEIGHTS_EXTRA_BUFFERS + 1
            ),
        )
    )


def psis_ess_values(data, *, var_name: str | None = None, reff: float | None = None):
    """Per-observation PSIS effective sample size ``1 / sum_s w_s^2``.

    Uses the smoothed, self-normalized LOO weights (R
    ``psis_n_eff_values`` analogue without the draw-count rescaling).
    """
    (ess,) = _reduce_loo_weights(
        data, var_name, reff, lambda ll, lw, k: (1.0 / torch.exp(2.0 * lw).sum(dim=1),)
    )
    return ess


def _mcse_rows(ll, lw, k):
    elpd_i = logsumexp(lw + ll, dim=1)
    rel = torch.exp(ll - elpd_i[:, None])
    rel_var = (torch.exp(2.0 * lw) * (rel - 1.0) ** 2).sum(dim=1)
    return torch.sqrt(rel_var), k


def mcse_loo(data, *, var_name: str | None = None, reff: float | None = None,
             pointwise: bool = False):
    """Monte-Carlo SE of ``elpd_loo`` under the smoothed LOO weights.

    Delta method on ``elpd_i = log sum_s w_s exp(ll_s)``: with
    ``a_s = lw_s + ll_s`` and ``elpd_i = logsumexp(a)``, the relative
    variance of the self-normalized IS estimate is

        rel_var_i = sum_s exp(2 lw_s) (exp(ll_s - elpd_i) - 1)^2

    and ``mcse_i = sqrt(rel_var_i)``; the total is
    ``sqrt(sum_i mcse_i^2)`` (R ``mcse_loo``'s aggregation).  Returns the
    total, or the per-observation vector with ``pointwise=True``.
    Observations with ``k̂ > 0.7`` have no finite-variance guarantee and
    yield NaN, matching R's behavior.
    """
    mcse_i, k = _reduce_loo_weights(data, var_name, reff, _mcse_rows)
    mcse_i = np.where(k > 0.7, np.nan, mcse_i)
    if pointwise:
        return mcse_i
    return float(np.sqrt(np.nansum(mcse_i**2))) if np.isfinite(
        mcse_i
    ).any() else float("nan")


def loo_pit(
    data=None,
    *,
    y=None,
    y_hat=None,
    var_name: str | None = None,
    reff: float | None = None,
):
    """LOO probability integral transform (calibration diagnostic).

    ``pit_i = sum_s w_is * 1[y_hat_is <= y_i]``, the leave-one-out
    posterior-predictive CDF evaluated at each observation, under the
    smoothed PSIS-LOO weights.  For a well-calibrated model the PIT values
    are ~Uniform(0, 1).  (ArviZ ``loo_pit`` semantics; the reference
    package has no analogue.)

    Parameters
    ----------
    data : InferenceData-convertible
        Carries the log-likelihood (for the weights); ``y``/``y_hat`` are
        pulled from its ``observed_data`` / ``posterior_predictive``
        groups when not given explicitly.
    y : (n_obs,) array, optional
    y_hat : (n_obs, S) or (chain, draw, n_obs) array, optional
    """
    inference_data = to_inference_data(data)
    if y is None:
        obs = getattr(inference_data, "observed_data", None)
        if obs is None or not list(getattr(obs, "data_vars", [])):
            raise ValueError("loo_pit needs `y` (or an observed_data group)")
        name = var_name if var_name in getattr(obs, "data_vars", {}) else (
            list(obs.data_vars)[0]
        )
        y = np.asarray(obs[name].values).ravel()
    if y_hat is None:
        pp = getattr(inference_data, "posterior_predictive", None)
        if pp is None or not list(getattr(pp, "data_vars", [])):
            raise ValueError(
                "loo_pit needs `y_hat` (or a posterior_predictive group)"
            )
        name = var_name if var_name in getattr(pp, "data_vars", {}) else (
            list(pp.data_vars)[0]
        )
        y_hat = np.asarray(pp[name].values)  # (chain, draw, *obs)
        y_hat = y_hat.reshape(y_hat.shape[0] * y_hat.shape[1], -1).T  # (n_obs, S)

    y = np.asarray(y).ravel()
    y_hat = np.asarray(y_hat)
    if y_hat.ndim == 3:  # (chain, draw, n_obs)
        y_hat = y_hat.reshape(y_hat.shape[0] * y_hat.shape[1], -1).T

    def predictions(ll):
        if y_hat.shape != tuple(ll.shape):
            raise ValueError(
                f"y_hat shape {y_hat.shape} does not match the (n_obs, S) "
                f"log-likelihood layout {tuple(ll.shape)}"
            )
        return torch.from_numpy(np.ascontiguousarray(y_hat)).to(ll.device, ll.dtype)

    def observations(ll):
        if y.shape[0] != ll.shape[0]:
            raise ValueError(
                f"y has {y.shape[0]} observations, log-likelihood has {ll.shape[0]}"
            )
        return torch.from_numpy(np.ascontiguousarray(y)).to(ll.device, ll.dtype)[:, None]

    (pit,) = _reduce_loo_weights(
        data, var_name, reff,
        lambda ll, lw, k, yh, yo: ((torch.exp(lw) * (yh <= yo)).sum(dim=1),),
        predictions, observations,
    )
    return DataArray(pit, ("obs",), {"obs": np.arange(len(pit))}, "loo_pit")


def relative_eff(x, *, method: str = "mean"):
    """Relative MCMC efficiency ``r_eff = ESS / S`` (R ``loo::relative_eff``).

    Parameters
    ----------
    x
        One of

        * an array shaped ``(chain, draw, *obs)``: e.g. the *likelihood*
          values ``exp(log_lik)`` per observation, or one parameter's draws.
          Returns an array shaped ``obs`` with one ``r_eff`` per element
          (a float when there are no trailing dims);
        * a :class:`~pyloo_tpu_torch.containers.DataArray` with leading
          ``chain``/``draw`` dims: same as above;
        * an ``InferenceData`` (or anything :func:`to_inference_data`
          accepts) / a dict of posterior variables: returns the scalar
          ``mean(ESS over all parameter elements) / S`` that
          :func:`pyloo_tpu_torch.loo` uses as its default ``reff``
          (reference ``pyloo/loo.py:204-216``).
    method
        ESS flavor; only ``"mean"`` (split-chain ESS of the mean,
        Vehtari et al. 2021) is implemented: it is the one the LOO
        pipeline consumes.

    Notes
    -----
    The per-observation form matches R ``loo``'s
    ``relative_eff(exp(log_lik), chain_id)`` usage; pass its mean (or the
    scalar form) to :func:`pyloo_tpu_torch.loo`'s ``reff=``.
    """
    from .ops.ess import ess_mean
    from .ops.ess import relative_eff as _dict_reff

    if method != "mean":
        raise ValueError(f"method must be 'mean', got {method!r}")

    if isinstance(x, dict):
        vals = {k: np.asarray(getattr(v, "values", v)) for k, v in x.items()}
        first = next(iter(vals.values()), None)
        if first is None:
            return 1.0
        n_samples = first.shape[0] * first.shape[1]
        return _dict_reff(vals, n_samples)

    values = getattr(x, "values", None)
    if values is None and not isinstance(x, (np.ndarray, torch.Tensor)):
        # InferenceData-like: scalar reff over the posterior group
        idata = to_inference_data(x)
        posterior = idata.posterior
        first = next(iter(posterior.data_vars.values()))
        n_samples = first.sizes["chain"] * first.sizes["draw"]
        return _dict_reff(
            {name: posterior[name].values for name in posterior.data_vars},
            n_samples,
        )

    arr = np.asarray(values if values is not None else x, dtype=np.float64)
    if arr.ndim < 2:
        raise ValueError(
            "relative_eff expects (chain, draw, *obs): got a"
            f" {arr.ndim}-d array; add a leading chain axis of size 1"
        )
    n_samples = arr.shape[0] * arr.shape[1]
    ess = ess_mean(arr)
    return (
        np.asarray(ess) / n_samples
        if arr.ndim > 2
        else float(ess) / n_samples
    )
