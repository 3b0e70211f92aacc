"""Leave-one-out cross-validation via importance sampling (PSIS/SIS/TIS).

Counterpart of ``pyloo_tpu/loo.py`` (reference ``pyloo/loo.py:20-626``): the
pipeline — ingestion, sample stacking, relative efficiency, importance
weighting, pointwise elpd and the derived statistics — is the same; the
per-observation work runs on the configured device
(:mod:`pyloo_tpu_torch.ops.loo_kernels`), the float32 path through the CUDA
prepass kernel.
"""

from __future__ import annotations

import warnings
from typing import Literal

import numpy as np
import torch

from ._common import (
    clean_log_likelihood,
    compute_device,
    compute_reff,
    good_k_threshold,
    resolve_scale,
)
from .base import ISMethod, _host, as_sample_matrix
from .containers import DataArray
from .elpd import ELPDData
from .ops import tail_length
from .ops.loo_kernels import (
    loo_scores_psis,
    loo_scores_psis_fast,
    loo_scores_sis,
    loo_scores_tis,
    mixture_scores,
)
from .parallel import apply_rowwise
from .rcparams import rcParams
from .utils import get_log_likelihood, to_inference_data

__all__ = ["loo"]


def loo(
    data,
    pointwise: bool | None = None,
    var_name: str | None = None,
    reff: float | None = None,
    scale: str | None = None,
    method: Literal["psis", "sis", "tis"] | ISMethod = "psis",
    moment_match: bool = False,
    jacobian: np.ndarray | None = None,
    mixture: bool = False,
    **kwargs,
) -> ELPDData:
    """Compute PSIS-LOO-CV (or SIS/TIS variants) for a fitted model.

    Parameters
    ----------
    data : InferenceData or convertible
        Must contain a ``log_likelihood`` group (and ``posterior`` when
        ``reff`` is not given).
    pointwise : bool, optional
        Return per-observation results. Defaults to ``stats.ic_pointwise``.
    var_name : str, optional
        Which log-likelihood variable to use when several are stored.
    reff : float, optional
        Relative MCMC efficiency ``ess / S``; estimated from the posterior
        when omitted.
    scale : {"log", "negative_log", "deviance"}, optional
    method : {"psis", "sis", "tis"}
    moment_match : bool
        Improve high-k observations by moment matching (requires pointwise
        results and a model wrapper or the custom-function kwargs).
    jacobian : array-like, optional
        Additive Jacobian adjustment to the pointwise elpd for transformed
        response variables (requires ``pointwise=True``).
    mixture : bool
        Compute Mix-IS-LOO (Silva & Zanella 2022) for draws from a mixture of
        leave-one-out posteriors.

    Returns
    -------
    ELPDData
        ``elpd_loo``/``se``/``p_loo``/``looic`` rows and, when pointwise,
        ``loo_i`` plus the method diagnostic (``pareto_k``/``ess``).

    The work runs on ``rcParams["device.device"]`` in
    ``rcParams["device.precision"]``; with ``"cuda"`` and no CUDA device this
    raises.

    Examples
    --------
    .. code-block:: python

        import pyloo_tpu_torch as pl

        idata = pl.load_example_data("centered_eight")
        result = pl.loo(idata, pointwise=True)
        print(result)            # elpd_loo, SE, p_loo, Pareto-k table
        result.loo_i             # per-observation elpd
        result.pareto_k          # per-observation diagnostics
    """
    compute_device()
    inference_data = to_inference_data(data)
    log_likelihood = get_log_likelihood(inference_data, var_name=var_name)
    pointwise = rcParams["stats.ic_pointwise"] if pointwise is None else pointwise

    if jacobian is not None and not pointwise:
        raise ValueError(
            "Jacobian adjustment requires pointwise LOO results. "
            "Please set pointwise=True when using jacobian_adjustment."
        )
    if moment_match and not pointwise:
        raise ValueError(
            "Moment matching requires pointwise LOO results. "
            "Please set pointwise=True when using moment_match=True."
        )

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

    matrix, _, _ = as_sample_matrix(log_likelihood)
    matrix = clean_log_likelihood(matrix, context="LOO")

    if method != ISMethod.PSIS:
        method_name = method.value.upper()
        warnings.warn(
            f"Using {method_name} for LOO computation. Note that PSIS is the"
            " recommended method as it is typically more efficient and reliable.",
            UserWarning,
            stacklevel=2,
        )

    good_k = good_k_threshold(n_samples)
    warn_mg = False
    n_degenerate = 0

    obs_dims = tuple(d for d in log_likelihood.dims if d != "__sample__")
    obs_coords = {
        d: c for d, c in log_likelihood.coords.items() if d in obs_dims
    }
    obs_shape = tuple(log_likelihood.sizes[d] for d in obs_dims)

    def as_obs_da(values, name=None):
        return DataArray(
            np.asarray(values).reshape(obs_shape), obs_dims, obs_coords, name
        )

    if mixture:
        warnings.warn(
            "Mix-IS-LOO requires a model that is sampled from a mixture of"
            " leave-one-out posteriors. Ensure the inference data passed to the `loo`"
            " function comes from a model that is sampled from such a distribution.",
            UserWarning,
            stacklevel=2,
        )
        # the mixture normalizer couples observations, so no row chunking
        elpd_mixis, lppd_i = map(_host, mixture_scores(matrix))
        diagnostic = as_obs_da(np.zeros(matrix.shape[0]), "pareto_k")
        loo_lppd_i = as_obs_da(scale_value * elpd_mixis, "loo_i")
    else:
        if method == ISMethod.PSIS:
            m_tail = tail_length(n_samples, reff)
            # float32 takes the fused-prepass fast path; float64 the
            # reference-exact path
            if matrix.dtype == torch.float32:
                elpd_i, diag, lppd_i, degen = map(
                    _host,
                    apply_rowwise(lambda b: loo_scores_psis_fast(b, m_tail), matrix),
                )
                n_degenerate = int(np.sum(degen))
                if n_degenerate:
                    warnings.warn(
                        f"The float32 fast path left {n_degenerate} observations"
                        " unsmoothed because their generalized Pareto fit was"
                        " degenerate (sigma <= 0). Their elpd contributions use"
                        " raw truncated weights. Recompute in float64"
                        " (rcParams['device.precision'] = 'float64') for"
                        " reference-exact handling of these observations.",
                        UserWarning,
                        stacklevel=2,
                    )
            else:
                elpd_i, diag, lppd_i = map(
                    _host, apply_rowwise(lambda b: loo_scores_psis(b, m_tail), matrix)
                )
        elif method == ISMethod.SIS:
            elpd_i, diag, lppd_i = map(_host, apply_rowwise(loo_scores_sis, matrix))
        else:
            elpd_i, diag, lppd_i = map(_host, apply_rowwise(loo_scores_tis, matrix))

        if method == ISMethod.PSIS:
            if np.any(diag > good_k):
                n_high_k = int(np.sum(diag > good_k))
                warnings.warn(
                    "Estimated shape parameter of Pareto distribution is greater than"
                    f" {good_k:.2f} for {n_high_k} observations. This indicates that"
                    " importance sampling may be unreliable because the marginal"
                    " posterior and LOO posterior are very different.",
                    UserWarning,
                    stacklevel=2,
                )
                warn_mg = True
        else:
            min_ess = float(np.min(diag))
            if min_ess < n_samples * 0.1:
                warnings.warn(
                    f"Low effective sample size detected (minimum ESS: {min_ess:.1f})."
                    " This indicates that the importance sampling approximation may be"
                    " unreliable. Consider using PSIS which is more robust to such"
                    " cases.",
                    UserWarning,
                    stacklevel=2,
                )
                warn_mg = True

        diagnostic = as_obs_da(
            diag, "pareto_k" if method == ISMethod.PSIS else "ess"
        )
        loo_lppd_i = as_obs_da(scale_value * elpd_i, "loo_i")

    loo_lppd = float(loo_lppd_i.values.sum())
    loo_lppd_se = float((n_data_points * np.var(loo_lppd_i.values)) ** 0.5)
    lppd = float(np.sum(lppd_i))
    p_loo = lppd - loo_lppd / scale_value
    p_loo_se = float(np.sqrt(np.sum(np.var(loo_lppd_i.values))))
    looic = -2 * loo_lppd
    looic_se = 2 * loo_lppd_se

    if not pointwise:
        result = _assemble(
            mixture, loo_lppd, loo_lppd_se, p_loo, p_loo_se, n_samples,
            n_data_points, warn_mg, scale, looic, looic_se,
            method=method, good_k=good_k,
        )
        result.fast_path_degenerate = n_degenerate
        return result

    if np.allclose(loo_lppd_i.values, loo_lppd_i.values.flat[0]):
        warnings.warn(
            "The point-wise LOO is the same with the sum LOO, please double check "
            "the Observed RV in your model to make sure it returns element-wise logp.",
            stacklevel=2,
        )

    result = _assemble(
        mixture, loo_lppd, loo_lppd_se, p_loo, p_loo_se, n_samples,
        n_data_points, warn_mg, scale, looic, looic_se,
        loo_lppd_i=loo_lppd_i, diagnostic=diagnostic,
        method=method, good_k=good_k,
    )
    # diagnostic attribute (not a row, so the report stays reference-shaped):
    # rows the float32 fast path left unsmoothed
    result.fast_path_degenerate = n_degenerate

    if jacobian is not None:
        jacobian_adj = np.asarray(jacobian)
        if jacobian_adj.shape != result.loo_i.shape:
            raise ValueError(
                f"Jacobian adjustment shape {jacobian_adj.shape} does not match "
                f"loo_i shape {result.loo_i.shape}"
            )
        result.loo_i.values = result.loo_i.values + jacobian_adj
        loo_lppd = float(result.loo_i.values.sum())
        loo_lppd_se = float((n_data_points * np.var(result.loo_i.values)) ** 0.5)
        result["elpd_loo"] = loo_lppd
        result["se"] = loo_lppd_se
        result["p_loo"] = lppd - loo_lppd / scale_value
        result["p_loo_se"] = float(np.sqrt(np.sum(np.var(result.loo_i.values))))
        result["looic"] = -2 * loo_lppd
        result["looic_se"] = 2 * loo_lppd_se

    if moment_match:
        wrapper = kwargs.get("wrapper", None)
        model_obj = wrapper
        mm_kwargs = {
            "max_iters": kwargs.get("max_iters", 30),
            "k_threshold": kwargs.get("k_threshold", None),
            "split": kwargs.get("split", True),
            "cov": kwargs.get("cov", True),
            "method": method,
            "verbose": kwargs.get("verbose", False),
        }
        if wrapper is None:
            model_obj = kwargs.get("model_obj", None)
            if model_obj is None:
                raise ValueError(
                    "When moment_match=True and no `wrapper` is provided, the custom "
                    "model object must be passed via the `model_obj` keyword argument."
                )
            custom_funcs = {
                "post_draws": kwargs.get("post_draws", None),
                "log_lik_i": kwargs.get("log_lik_i", None),
                "unconstrain_pars": kwargs.get("unconstrain_pars", None),
                "log_prob_upars_fn": kwargs.get("log_prob_upars_fn", None),
                "log_lik_i_upars_fn": kwargs.get("log_lik_i_upars_fn", None),
            }
            mm_kwargs.update(custom_funcs)
            missing = [k for k, v in custom_funcs.items() if v is None]
            if missing:
                raise ValueError(
                    "When moment_match=True and no `wrapper` is provided, the"
                    " following functions must be passed via kwargs:"
                    f" {', '.join(missing)}"
                )
        handled = set(mm_kwargs) | {
            "wrapper", "pointwise", "var_name", "reff", "scale", "method",
            "moment_match", "jacobian", "mixture", "model_obj", "post_draws",
            "log_lik_i", "unconstrain_pars", "log_prob_upars_fn",
            "log_lik_i_upars_fn",
        }
        mm_kwargs.update({k: v for k, v in kwargs.items() if k not in handled})
        from .loo_moment_match import loo_moment_match

        result = loo_moment_match(model_obj, result, **mm_kwargs)

    return result


def _assemble(
    mixture, loo_lppd, loo_lppd_se, p_loo, p_loo_se, n_samples, n_data_points,
    warn_mg, scale, looic, looic_se, loo_lppd_i=None, diagnostic=None,
    method=ISMethod.PSIS, good_k=None,
):
    """Build the ELPDData rows in the reference order (loo.py:516-626)."""
    if mixture:
        rows = [
            ("elpd_loo", loo_lppd),
            ("se", loo_lppd_se),
            ("n_samples", n_samples),
            ("n_data_points", n_data_points),
            ("warning", warn_mg),
        ]
    else:
        rows = [
            ("elpd_loo", loo_lppd),
            ("se", loo_lppd_se),
            ("p_loo", p_loo),
            ("p_loo_se", p_loo_se),
            ("n_samples", n_samples),
            ("n_data_points", n_data_points),
            ("warning", warn_mg),
        ]
    if loo_lppd_i is not None:
        rows.append(("loo_i", loo_lppd_i.rename("loo_i")))
    rows.append(("scale", scale))
    if not mixture:
        rows.append(("looic", looic))
        rows.append(("looic_se", looic_se))
    if loo_lppd_i is not None and diagnostic is not None:
        if method == ISMethod.PSIS:
            rows.append(("pareto_k", diagnostic))
            rows.append(("good_k", good_k))
        else:
            rows.append(("ess", diagnostic))
    elif method == ISMethod.PSIS:
        rows.append(("good_k", good_k))
    rows.append(("subsample_size", n_data_points))
    return ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
