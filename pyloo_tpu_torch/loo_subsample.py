"""Subsampled LOO-CV for large data (Magnusson et al., ICML 2019).

Counterpart of ``pyloo_tpu/loo_subsample.py`` (reference
``pyloo/loo_subsample.py:37-679``): compute a cheap elpd approximation for
all N observations (one pass over row chunks on the device), draw a
subsample on the host from numpy's random streams (the same seed draws the
same rows as ``pyloo_tpu``), run exact PSIS-LOO on the sampled rows only,
on the device, and estimate the population elpd with the chosen survey
estimator.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from ._common import (
    clean_log_likelihood,
    compute_device,
    compute_reff,
    good_k_threshold,
    resolve_scale,
)
from .base import _host, as_sample_matrix
from .constants import EstimatorMethod, LooApproximationMethod
from .containers import DataArray
from .elpd import ELPDData
from .estimators import (
    SimpleRandomSamplingEstimator,
    SubsampleIndices,
    compute_sampling_probabilities,
    get_estimator,
    subsample_indices,
)
from .approximations import (
    LPDApproximation,
    PLPDApproximation,
    SISApproximation,
    TISApproximation,
)
from .loo import loo
from .loo_approximate_posterior import importance_resample
from .ops import tail_length
from .ops.loo_kernels import loo_scores_psis
from .parallel import apply_rowwise
from .rcparams import rcParams
from .utils import get_log_likelihood, to_inference_data

__all__ = ["loo_subsample", "update_subsample"]

APPROXIMATION_METHODS = {
    LooApproximationMethod.LPD: LPDApproximation,
    LooApproximationMethod.TIS: TISApproximation,
    LooApproximationMethod.SIS: SISApproximation,
}


def loo_subsample(
    data,
    observations: int | np.ndarray | None = 100,
    loo_approximation: str = "plpd",
    estimator: str = "diff_srs",
    loo_approximation_draws: int | None = None,
    log_p: np.ndarray | None = None,
    log_q: np.ndarray | None = None,
    pointwise: bool | None = None,
    var_name: str | None = None,
    reff: float | None = None,
    scale: str | None = None,
    resample_method: str = "psis",
    seed: int | None = None,
) -> ELPDData:
    """Approximate LOO-CV by exact PSIS on a statistical subsample.

    Parameters
    ----------
    observations : int, array of indices, or None
        Subsample size (drawn per ``estimator``), explicit indices, or None
        for full LOO.
    loo_approximation : {"plpd", "lpd", "tis", "sis"}
        Cheap per-observation elpd guess computed for all N observations.
    estimator : {"diff_srs", "hh_pps", "srs"}
        Population-elpd estimator.
    log_p, log_q : arrays, optional
        Target/proposal log-densities enabling a posterior-approximation
        correction via importance resampling of the draws.

    Returns
    -------
    ELPDData with subsampling rows (``subsampling_SE``, ``subsample_size``)
    and stored parameters enabling :func:`update_subsample`.

    Examples
    --------
    .. code-block:: python

        import pyloo_tpu_torch as pl

        sub = pl.loo_subsample(big_idata, observations=400)
        print(sub["elpd_loo"], "+-", sub["subsampling_SE"])
        more = pl.update_subsample(sub, observations=800)
    """
    compute_device()
    inference_data = to_inference_data(data)
    log_likelihood = get_log_likelihood(inference_data, var_name=var_name)
    pointwise = rcParams["stats.ic_pointwise"] if pointwise is None else pointwise

    try:
        loo_approx_method = LooApproximationMethod(loo_approximation.lower())
    except ValueError:
        raise ValueError(
            f"Invalid loo_approximation '{loo_approximation}'. "
            f"Must be one of: {', '.join(m.value for m in LooApproximationMethod)}"
        )
    if estimator is None:
        estimator = "diff_srs"
    try:
        est_method = EstimatorMethod(estimator.lower())
    except ValueError:
        raise ValueError(
            f"Invalid estimator '{estimator}'. "
            f"Must be one of: {', '.join(m.value for m in EstimatorMethod)}"
        )

    log_likelihood = log_likelihood.stack(__sample__=("chain", "draw"))
    shape = log_likelihood.shape
    n_samples = shape[-1]
    obs_dims = [d for d in log_likelihood.dims if d != "__sample__"]
    n_data_points = int(np.prod([log_likelihood.sizes[d] for d in obs_dims]))
    scale, scale_value = resolve_scale(scale)

    reff = compute_reff(inference_data, reff, n_samples)
    matrix, _, _ = as_sample_matrix(log_likelihood)  # (N, S) on the device
    cleaned = clean_log_likelihood(matrix, context="LOO")
    if cleaned is not matrix:  # NaN replaced: the approximations read the cleaned values
        obs_dims = [d for d in log_likelihood.dims if d != "__sample__"]
        log_likelihood = DataArray(
            _host(cleaned).reshape([log_likelihood.sizes[d] for d in obs_dims] + [n_samples]),
            tuple(obs_dims) + ("__sample__",),
            {d: c for d, c in log_likelihood.coords.items() if d in obs_dims},
            log_likelihood.name,
        )
    matrix = cleaned
    del cleaned

    if observations is None:
        return loo(
            data=data, pointwise=pointwise, var_name=var_name, reff=reff, scale=scale
        )

    if isinstance(observations, (int, np.integer)):
        if observations <= 0 or observations > n_data_points:
            raise ValueError(
                f"Number of observations must be between 1 and {n_data_points}, "
                f"got {observations}"
            )
    elif isinstance(observations, np.ndarray):
        if not np.issubdtype(observations.dtype, np.integer):
            raise TypeError("observations array must contain integers")
        if observations.min() < 0 or observations.max() >= n_data_points:
            raise ValueError(
                f"Observation indices must be between 0 and {n_data_points - 1}, "
                f"got range [{observations.min()}, {observations.max()}]"
            )
    else:
        raise TypeError(
            "observations must be None, an integer, or an array of integers"
        )

    # -- cheap approximation for every observation (row chunks on the device)
    if loo_approx_method == LooApproximationMethod.PLPD:
        if hasattr(inference_data, "posterior"):
            approximator = PLPDApproximation(posterior=inference_data.posterior)
        else:
            warnings.warn(
                "PLPD approximation requested but posterior draws not available. "
                "Falling back to LPD approximation.",
                UserWarning,
                stacklevel=2,
            )
            approximator = LPDApproximation()
    else:
        approximator = APPROXIMATION_METHODS[loo_approx_method]()

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        elpd_loo_approx = np.asarray(
            approximator.compute_approximation(
                log_likelihood=log_likelihood, n_draws=loo_approximation_draws
            )
        ).ravel()

    # -- draw the subsample --------------------------------------------------
    if isinstance(observations, np.ndarray):
        indices = SubsampleIndices(
            idx=observations, m_i=np.ones_like(observations)
        )
    else:
        indices = subsample_indices(
            estimator=est_method.value,
            elpd_loo_approximation=elpd_loo_approx,
            observations=int(observations),
            rng=np.random.default_rng(seed) if seed is not None else None,
        )

    device = matrix.device
    ll_sample = matrix.index_select(0, torch.as_tensor(indices.idx, dtype=torch.int64,
                                                       device=device))  # (m, S)
    del matrix

    # -- optional posterior-approximation correction -------------------------
    if log_p is not None and log_q is not None:
        if len(log_p) != len(log_q):
            raise ValueError(
                f"log_p and log_q must have the same length, got {len(log_p)} and"
                f" {len(log_q)}"
            )
        try:
            resample_idx = importance_resample(
                log_p=log_p, log_q=log_q, method=resample_method, seed=seed
            )
            ll_sample = ll_sample.index_select(
                1, torch.as_tensor(resample_idx, dtype=torch.int64, device=device)
            )
        except Exception as e:
            warnings.warn(
                f"Importance resampling failed: {str(e)}. Falling back to original"
                " samples.",
                UserWarning,
                stacklevel=2,
            )

    # -- exact PSIS-LOO on the m sampled rows --------------------------------
    loo_lppd_i, diagnostic, p_loo_values = _score_sampled(ll_sample, reff, scale_value)
    del ll_sample

    # -- population estimates and the result -----------------------------------
    loo_lppd_i_full = np.full(n_data_points, np.nan)
    loo_lppd_i_full[indices.idx] = loo_lppd_i
    if len(obs_dims) > 1:
        loo_lppd_i_full = loo_lppd_i_full.reshape(
            [log_likelihood.sizes[d] for d in obs_dims]
        )
    result = _subsample_result(
        est_method, elpd_loo_approx, indices, loo_lppd_i, diagnostic, p_loo_values,
        n_samples, n_data_points, scale, loo_lppd_i_full if pointwise else None,
    )
    sampled = loo_lppd_i_full[~np.isnan(loo_lppd_i_full)]
    if len(sampled) > 0 and np.allclose(sampled, sampled[0]):
        warnings.warn(
            "The point-wise LOO is the same with the sum LOO, please double check "
            "the Observed RV in your model to make sure it returns element-wise logp.",
            UserWarning,
            stacklevel=2,
        )

    result.estimates.data = inference_data
    result.estimates.loo_approximation = loo_approximation
    result.estimates.estimator = estimator
    result.estimates.loo_approximation_draws = loo_approximation_draws
    result.estimates.var_name = var_name
    result.method = "loo_subsample"

    if log_p is not None and log_q is not None:
        result.log_p = log_p
        result.log_q = log_q
        result.resample_method = resample_method
        result.seed = seed

    return result


def _score_sampled(ll_sample, reff, scale_value, mesh=None, decide_over="chunks"):
    """Exact PSIS-LOO of the ``(m, S)`` sampled rows on the device (over
    ``mesh``, or the default one): the scaled pointwise elpd, the Pareto k
    and the variance over draws, on the host.  ``decide_over`` is
    ``apply_rowwise``'s: ``"call"`` for the streaming form, whose rows
    ``pyloo_tpu`` scores in one call (``streaming.py:979``)."""
    m_tail = tail_length(ll_sample.shape[1], reff)
    elpd_sample, diagnostic, _ = apply_rowwise(
        lambda b: loo_scores_psis(b, m_tail), ll_sample, mesh=mesh, decide_over=decide_over
    )
    p_loo_values = _host(ll_sample.var(dim=1, correction=0))  # var over draws per sampled obs
    return scale_value * _host(elpd_sample), _host(diagnostic), p_loo_values


def _subsample_result(est_method, elpd_loo_approx, indices, loo_lppd_i, diagnostic,
                      p_loo_values, n_samples, n_data_points, scale, loo_lppd_i_full):
    """Population estimates, the diagnostic warning and the ELPDData rows of
    :func:`loo_subsample` and ``loo_subsample_streaming``; pointwise rows
    when ``loo_lppd_i_full`` (the sampled values scattered into all
    observations) is given."""
    estimator_impl = get_estimator(est_method.value)
    if est_method == EstimatorMethod.HH_PPS:
        z = compute_sampling_probabilities(elpd_loo_approx)
        z_sample = z[indices.idx]
        estimates = estimator_impl.estimate(
            z=z_sample, m_i=indices.m_i, y=loo_lppd_i, N=n_data_points
        )
        p_loo_estimates = estimator_impl.estimate(
            z=z_sample, m_i=indices.m_i, y=p_loo_values, N=n_data_points
        )
    elif est_method == EstimatorMethod.SRS:
        estimates = estimator_impl.estimate(y=loo_lppd_i, N=n_data_points)
        p_loo_estimates = estimator_impl.estimate(y=p_loo_values, N=n_data_points)
    else:  # diff_srs
        estimates = estimator_impl.estimate(
            y_approx=elpd_loo_approx, y=loo_lppd_i, y_idx=indices.idx
        )
        p_loo_estimates = SimpleRandomSamplingEstimator().estimate(
            y=p_loo_values, N=n_data_points
        )

    # the difference estimator's variance estimates can come out negative on
    # small subsamples; clamp at zero so se stays a number (reference leaves
    # this unguarded and leaks NaN)
    p_loo = p_loo_estimates.y_hat
    p_loo_se = np.sqrt(max(p_loo_estimates.hat_v_y, 0.0))
    p_loo_subsampling_se = np.sqrt(max(p_loo_estimates.v_y_hat, 0.0))
    se = np.sqrt(max(estimates.hat_v_y, 0.0))
    subsampling_se = np.sqrt(max(estimates.v_y_hat, 0.0))
    looic = -2 * estimates.y_hat
    looic_se = 2 * se
    looic_subsamp_se = 2 * subsampling_se

    good_k = good_k_threshold(n_samples)
    max_k = np.nanmax(diagnostic) if not np.all(np.isnan(diagnostic)) else 0
    warn_mg = False
    if est_method == EstimatorMethod.SRS:
        # the reference treats SRS diagnostics as ESS-like (loo_subsample.py:454-464)
        min_ess = float(np.min(diagnostic))
        if min_ess < n_samples * 0.1:
            warnings.warn(
                f"Low effective sample size detected (minimum ESS: {min_ess:.1f}). This"
                " indicates that the importance sampling approximation may be"
                " unreliable. Consider using PSIS which is more robust to such cases.",
                UserWarning,
                stacklevel=3,
            )
            warn_mg = True
    elif max_k > good_k:
        n_high_k = int(np.sum(diagnostic > good_k))
        warnings.warn(
            "Estimated shape parameter of Pareto distribution is greater than"
            f" {good_k:.2f} for {n_high_k} observations. This indicates that"
            " importance sampling may be unreliable because the marginal posterior"
            " and LOO posterior are very different.",
            UserWarning,
            stacklevel=3,
        )
        warn_mg = True

    pointwise = loo_lppd_i_full is not None
    rows: list[tuple[str, Any]] = [
        ("elpd_loo", estimates.y_hat),
        ("se", se),
        ("p_loo", p_loo),
        ("p_loo_se", p_loo_se),
        ("p_loo_subsampling_se", p_loo_subsampling_se),
        ("n_samples", n_samples),
        ("n_data_points", n_data_points),
        ("warning", warn_mg),
    ]
    if pointwise:
        rows.append(("loo_i", DataArray(loo_lppd_i_full, name="loo_i")))
    rows += [
        ("scale", scale),
        ("good_k", good_k),
        ("subsampling_SE", subsampling_se),
        ("subsample_size", len(indices.idx)),
        ("looic", looic),
        ("looic_se", looic_se),
        ("looic_subsamp_se", looic_subsamp_se),
    ]
    if pointwise:
        rows.append(("pareto_k", diagnostic))
    rows.append(("method", "loo_subsample"))

    result = ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
    result.estimates = estimates
    result.estimates.indices = indices
    return result


def update_subsample(
    loo_data: ELPDData,
    observations: int | np.ndarray | None = None,
    **kwargs,
) -> ELPDData:
    """Re-run a subsampled LOO with new observations or overridden params.

    Uses the data and parameters stored on the original result, mirroring
    reference ``loo_subsample.py:610-679``.
    """
    if not isinstance(loo_data, ELPDData):
        raise TypeError("loo_data must be an ELPDData object from loo_subsample()")

    stream = getattr(loo_data.estimates, "stream", None)
    if stream is not None:
        # result came from loo_subsample_streaming: re-dispatch through the
        # generator interface, reusing the stored (n_obs,) approximation so
        # the update only makes the new subsample's rows
        from .streaming import loo_subsample_streaming

        params = {
            "observations": (
                observations
                if observations is not None
                else loo_data["subsample_size"]
            ),
            "estimator": getattr(loo_data.estimates, "estimator", "diff_srs"),
            "elpd_loo_approximation": stream["elpd_loo_approximation"],
            "reff": stream["reff"],
            "chunk_size": stream["chunk_size"],
            "pointwise": "loo_i" in loo_data,
            "scale": loo_data["scale"],
            "dtype": stream["dtype"],
            "mesh": stream.get("mesh"),
            "seed": None,
        }
        params.update(kwargs)
        return loo_subsample_streaming(
            stream["log_lik_fn"], stream["n_obs"], stream["n_draws"],
            **params,
        )

    if not hasattr(loo_data.estimates, "data"):
        raise ValueError("Cannot update: original data not available")

    params = {
        "data": loo_data.estimates.data,
        "observations": (
            observations if observations is not None else loo_data["subsample_size"]
        ),
        "loo_approximation": getattr(loo_data.estimates, "loo_approximation", "plpd"),
        "estimator": getattr(loo_data.estimates, "estimator", "diff_srs"),
        "loo_approximation_draws": getattr(
            loo_data.estimates, "loo_approximation_draws", None
        ),
        "pointwise": "loo_i" in loo_data,
        "var_name": getattr(loo_data.estimates, "var_name", None),
        "reff": loo_data.get("r_eff", None),
        "scale": loo_data["scale"],
        "log_p": getattr(loo_data, "log_p", None),
        "log_q": getattr(loo_data, "log_q", None),
        "resample_method": getattr(loo_data, "resample_method", "psis"),
        "seed": getattr(loo_data, "seed", None),
    }
    params.update(kwargs)
    return loo_subsample(**params)
