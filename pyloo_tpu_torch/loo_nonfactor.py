"""LOO-CV for non-factorized multivariate normal / Student-t models.

Counterpart of ``pyloo_tpu/loo_nonfactor.py`` (reference
``pyloo/loo_nonfactor.py:21-786``; Bürkner, Gabry & Vehtari 2021, "Efficient
leave-one-out cross-validation for Bayesian non-factorized normal and
Student-t models", Comput. Stat. 36).  The conditional leave-one-out
densities of every draw come from :mod:`pyloo_tpu_torch.ops.nonfactor` on
the device, the draws' matrices copied there a chunk at a time, and the
importance weights from :func:`pyloo_tpu_torch.compute_importance_weights`
there too.  With ``rcParams["device.auto_shard"]`` and more than one CUDA
device, the chunks of draws are dealt over every device of
:func:`pyloo_tpu_torch.parallel.obs_mesh`, as ``pyloo_tpu`` shards the draws
over its mesh; the estimates are those of one device bit for bit.

Three deliberate differences from the reference, each with its warning, are
``pyloo_tpu``'s: a precision matrix is used as given (the reference inverts
it); draws with non-positive degrees of freedom are dropped; draws whose
covariance factorisation fails are dropped.
"""

from __future__ import annotations

import warnings
from typing import Any, Literal

import numpy as np
import torch

from ._common import compute_device, compute_reff, good_k_threshold, resolve_scale
from .base import ISMethod, compute_importance_weights
from .containers import DataArray
from .elpd import ELPDData
from .ops.nonfactor import mvn_conditional_loglik, mvt_conditional_loglik
from .parallel.sharding import default_mesh
from .rcparams import rcParams
from .utils import _logsumexp, to_inference_data

__all__ = ["loo_nonfactor"]


def loo_nonfactor(
    data,
    pointwise: bool | None = None,
    var_name: str | None = None,
    reff: float | None = None,
    scale: str | None = None,
    method: Literal["psis", "sis", "tis"] | ISMethod = "psis",
    mu_var_name: str = "mu",
    cov_var_name: str | None = None,
    prec_var_name: str | None = None,
    model_type: Literal["normal", "student_t"] = "normal",
    df_var_name: str = "df",
) -> ELPDData:
    """LOO-CV when the likelihood is a joint MVN/MVT over all observations.

    The posterior must carry the mean vector (``mu_var_name``) and either a
    covariance (``cov_var_name``/"cov") or precision (``prec_var_name``/
    "prec") matrix per draw — and for Student-t models a degrees-of-freedom
    variable.  Conditional leave-one-out densities are computed analytically
    per draw, then importance-weighted as usual.

    Note: a supplied precision matrix is used directly as C^-1.  (The
    reference inverts it, ``loo_nonfactor.py:476-481``, i.e. treats the
    covariance as the precision, which inverts the conditional densities'
    meaning; this implementation follows the math of the paper.)

    Runs on ``rcParams["device.device"]``; with ``"cuda"`` and no CUDA device
    this raises.  The ``(S, N, N)`` matrices stay where they are (on the
    host for an InferenceData) and reach the device a chunk of draws at a
    time.
    """
    warnings.warn(
        f"loo_nonfactor() with model_type='{model_type}' requires the correct model"
        " specification. Using this function with mismatched models will produce"
        " incorrect results.",
        UserWarning,
        stacklevel=2,
    )
    if model_type not in ("normal", "student_t"):
        raise ValueError(
            f"model_type must be 'normal' or 'student_t', got {model_type!r}"
        )

    compute_device()
    inference_data = to_inference_data(data)
    _validate_model_structure(
        inference_data, mu_var_name, cov_var_name, prec_var_name, model_type,
        df_var_name,
    )
    if not hasattr(inference_data, "observed_data"):
        raise TypeError("Must be able to extract an observed_data group from data.")
    if not hasattr(inference_data, "posterior"):
        raise TypeError("Must be able to extract a posterior group from data.")

    pointwise = rcParams["stats.ic_pointwise"] if pointwise is None else pointwise
    scale, scale_value = resolve_scale(scale)

    obs_group = inference_data.observed_data
    if var_name is None:
        obs_vars = list(obs_group.data_vars)
        if len(obs_vars) == 1:
            var_name = obs_vars[0]
        elif not obs_vars:
            raise ValueError("No variables found in observed_data group.")
        else:
            raise ValueError(
                f"Multiple variables found in observed_data: {obs_vars}. "
                "Please specify the response variable using `var_name`."
            )
    try:
        y = obs_group[var_name]
    except KeyError:
        raise ValueError(f"Variable '{var_name}' not found in observed_data group.")
    if y.ndim != 1:
        raise ValueError(
            f"Observed data '{var_name}' must be 1-dimensional (N,). Found shape"
            f" {y.shape}."
        )
    n_data_points = y.shape[0]
    obs_dim = y.dims[0]
    obs_coord = dict(y.coords)

    post_group = inference_data.posterior
    if mu_var_name not in post_group.data_vars:
        raise ValueError(f"Posterior variable '{mu_var_name}' not found.")
    mu = post_group[mu_var_name]

    cov_matrix = prec_matrix = None
    if cov_var_name:
        if cov_var_name not in post_group.data_vars:
            raise ValueError(f"Posterior variable '{cov_var_name}' not found.")
        cov_matrix = post_group[cov_var_name]
    elif prec_var_name:
        if prec_var_name not in post_group.data_vars:
            raise ValueError(f"Posterior variable '{prec_var_name}' not found.")
        prec_matrix = post_group[prec_var_name]
    else:
        if "cov" in post_group.data_vars:
            cov_matrix, cov_var_name = post_group["cov"], "cov"
        elif "prec" in post_group.data_vars:
            prec_matrix, prec_var_name = post_group["prec"], "prec"
    if cov_matrix is None and prec_matrix is None:
        raise ValueError(
            "Could not find posterior samples for covariance ('cov') or precision"
            " ('prec') matrix. Specify the variable name using `cov_var_name` or"
            " `prec_var_name`."
        )

    # draws first: (chain, draw, ...) -> (S, ...), the order of stacking
    # (chain, draw) into __sample__; a view where the dims are in that order
    def draws_first(da):
        rest = tuple(d for d in da.dims if d not in ("chain", "draw"))
        values = da.transpose("chain", "draw", *rest).values
        return values.reshape((-1,) + values.shape[2:])

    mu_s = draws_first(mu)  # (S, N)
    if mu_s.shape[-1] != n_data_points:
        raise ValueError(
            f"Mean vector '{mu_var_name}' shape {mu_s.shape[1:]} is incompatible"
            f" with observed data size {n_data_points}."
        )
    S = mu_s.shape[0]

    mats = draws_first(cov_matrix if cov_matrix is not None else prec_matrix)
    if mats.shape != (S, n_data_points, n_data_points):
        name = cov_var_name or prec_var_name
        raise ValueError(
            f"Matrix '{name}' shape {mats.shape[1:]} is incompatible with"
            f" observed data size {n_data_points} and number of samples {S}."
        )

    reff = compute_reff(inference_data, reff, S)
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

    y_vals = np.asarray(y.values, dtype=np.float64)

    # draws are the parallel axis here (each needs the full N x N matrix),
    # so they are sharded over the mesh (SURVEY.md section 5)
    mesh = default_mesh(compute_device()) if rcParams["device.auto_shard"] else None
    kwargs = (
        {"cov": mats} if cov_matrix is not None else {"prec": mats}
    )
    kwargs["mesh"] = mesh
    if model_type == "normal":
        ll = mvn_conditional_loglik(y_vals, mu_s, **kwargs)
    else:
        if df_var_name not in post_group.data_vars:
            raise ValueError(
                f"Degrees of freedom variable '{df_var_name}' not found in"
                " posterior. Please specify the correct variable name using"
                " 'df_var_name'."
            )
        df_s = np.asarray(draws_first(post_group[df_var_name]).reshape(S))
        bad_df = df_s <= 0
        if bad_df.any():
            # deliberate deviation from the reference (loo_nonfactor.py:508-516,
            # which keeps the draws at -inf and thereby poisons every row's
            # importance weights): the invalid draws are excluded entirely
            warnings.warn(
                f"Non-positive degrees of freedom for {int(bad_df.sum())}"
                " draws. Excluding those draws from the LOO computation"
                f" (effective draw count reduced by {int(bad_df.sum())}).",
                UserWarning,
                stacklevel=2,
            )
            df_s = np.where(bad_df, 1.0, df_s)
        ll = mvt_conditional_loglik(y_vals, mu_s, df_s, **kwargs)
        if bad_df.any():
            # exclude the invalid draws entirely: keeping them at -inf (the
            # reference's stance) poisons every row's importance weights,
            # while a posterior draw that cannot produce a likelihood
            # carries no usable information
            ll = ll[torch.as_tensor(~bad_df, device=ll.device)]
            S = ll.shape[0]
            if S < 2:
                raise ValueError(
                    "All posterior draws have non-positive degrees of"
                    " freedom; cannot compute LOO."
                )

    ll = ll.T.cpu().numpy()  # (N, S)

    # draws whose factorization failed (singular / non-PD covariance) carry
    # -inf for EVERY observation; keeping them (the reference's stance,
    # loo_nonfactor.py:470-481) turns the raw importance weight -ll into
    # +inf and poisons every observation's PSIS fit — exclude them, exactly
    # like the non-positive-df deviation above
    dead_draw = np.all(~np.isfinite(ll), axis=0)
    if dead_draw.any():
        warnings.warn(
            f"Covariance factorization failed for {int(dead_draw.sum())}"
            " draws (singular or non-positive-definite matrix). Excluding"
            " those draws from the LOO computation (effective draw count"
            f" reduced by {int(dead_draw.sum())}).",
            UserWarning,
            stacklevel=2,
        )
        ll = ll[:, ~dead_draw]
        S = ll.shape[1]
        if S < 2:
            raise ValueError(
                "All posterior draws have singular covariance matrices;"
                " cannot compute LOO."
            )

    if np.any(np.isnan(ll)) or np.any(np.isneginf(ll)):
        ll = np.where(np.isnan(ll), -np.inf, ll)
        warnings.warn(
            "Invalid values detected in log-likelihood calculation. "
            "NaN values have been replaced with -inf. "
            "Points with -inf values will have zero weight in the final calculation.",
            UserWarning,
            stacklevel=2,
        )

    log_weights, diagnostic = compute_importance_weights(
        DataArray(-ll, (obs_dim, "__sample__"), obs_coord),
        method=method,
        reff=reff,
    )
    lw = log_weights.values + ll

    warn_mg = False
    good_k = good_k_threshold(S) if S > 1 else 0.7
    diag = np.asarray(diagnostic.values)
    if method == ISMethod.PSIS:
        if np.any(diag > good_k):
            n_high_k = int(np.sum(diag > good_k))
            warnings.warn(
                "Estimated shape parameter of Pareto distribution is greater than"
                f" {good_k:.2f} for {n_high_k} observations. This indicates that"
                " importance sampling may be unreliable. Consider running moment"
                " matching or exact LOO-CV.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True
    else:
        min_ess = float(np.min(diag))
        if min_ess < S * 0.1:
            warnings.warn(
                f"Low effective sample size detected (minimum ESS: {min_ess:.1f})."
                " Importance sampling approximation may be unreliable. Consider using"
                " PSIS.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True

    loo_lppd_i = DataArray(
        scale_value * _logsumexp(lw, axis=-1), (obs_dim,), obs_coord, "loo_i"
    )
    loo_lppd = float(loo_lppd_i.values.sum())
    loo_lppd_se = float((n_data_points * np.var(loo_lppd_i.values)) ** 0.5)
    lppd = float(np.sum(_logsumexp(ll, b_inv=S, axis=-1)))
    p_loo = lppd - loo_lppd / scale_value
    p_loo_se = float(np.sqrt(np.sum(np.var(loo_lppd_i.values))))
    looic = -2 * loo_lppd
    looic_se = 2 * loo_lppd_se

    rows: list[tuple[str, Any]] = [
        ("elpd_loo", loo_lppd),
        ("se", loo_lppd_se),
        ("p_loo", p_loo),
        ("p_loo_se", p_loo_se),
        ("n_samples", S),
        ("n_data_points", n_data_points),
        ("warning", warn_mg),
    ]
    if pointwise:
        rows.append(("loo_i", loo_lppd_i))
    rows += [("scale", scale), ("looic", looic), ("looic_se", looic_se)]
    if pointwise:
        diag_name = "pareto_k" if method == ISMethod.PSIS else "ess"
        rows.append((diag_name, diagnostic.rename(diag_name)))
        if method == ISMethod.PSIS:
            rows.append(("good_k", good_k))

    result = ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
    result.attrs = {"is_mvn": True, "model_type": model_type}
    return result


def _validate_model_structure(
    inference_data, mu_var_name, cov_var_name, prec_var_name,
    model_type="normal", df_var_name="df",
):
    """Warn when the posterior clearly lacks the MVN/MVT structure."""
    if not hasattr(inference_data, "posterior"):
        return False
    posterior = inference_data.posterior
    if mu_var_name not in posterior.data_vars:
        warnings.warn(
            f"Mean vector '{mu_var_name}' not found in posterior. "
            "This function requires a multivariate normal model with a mean vector.",
            UserWarning,
            stacklevel=3,
        )
        return False
    has_cov = (
        cov_var_name is not None and cov_var_name in posterior.data_vars
    ) or "cov" in posterior.data_vars
    has_prec = (
        prec_var_name is not None and prec_var_name in posterior.data_vars
    ) or "prec" in posterior.data_vars
    if not (has_cov or has_prec):
        warnings.warn(
            "Neither covariance nor precision matrix found in posterior. "
            "loo_nonfactor() requires a multivariate normal model with either "
            "a covariance or precision matrix.",
            UserWarning,
            stacklevel=3,
        )
        return False
    if model_type == "student_t" and df_var_name not in posterior.data_vars:
        warnings.warn(
            f"Degrees of freedom variable '{df_var_name}' not found in posterior. "
            "Student-t models require a degrees of freedom parameter. "
            "Verify the variable name using the 'df_var_name' parameter.",
            UserWarning,
            stacklevel=3,
        )
        return False
    return True
