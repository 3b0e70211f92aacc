"""Leave-one-group-out cross-validation (LOGO-CV).

Counterpart of ``pyloo_tpu/loo_group.py`` (reference
``pyloo/loo_group.py:19-379``).  The group sums are one ``index_add_`` on the
device; the per-group IS step runs the LOO scorers over the
``(n_groups, S)`` matrix.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from ._common import clean_log_likelihood, compute_reff, good_k_threshold, resolve_scale
from .base import ISMethod, _host, as_sample_matrix
from .containers import DataArray
from .elpd import ELPDData
from .ops import tail_length
from .ops.loo_kernels import loo_scores_psis, loo_scores_sis, loo_scores_tis
from .parallel import apply_rowwise
from .rcparams import rcParams
from .utils import get_log_likelihood, to_inference_data

__all__ = ["loo_group"]


def loo_group(
    data,
    group_ids: np.ndarray,
    pointwise: bool | None = None,
    var_name: str | None = None,
    reff: float | None = None,
    scale: str | None = None,
    method="psis",
) -> ELPDData:
    """LOGO-CV: leave out whole groups of observations at once.

    ``group_ids`` assigns every observation to a group; within-group
    log-likelihoods are summed before importance weighting, so the weights
    target the leave-one-group-out posterior.

    Returns an ELPDData with ``elpd_logo``/``p_logo``/``logoic`` rows (and
    per-group ``logo_i``/diagnostics when pointwise).
    """
    inference_data = to_inference_data(data)
    log_likelihood = get_log_likelihood(inference_data, var_name=var_name)
    pointwise = rcParams["stats.ic_pointwise"] if pointwise is None else pointwise

    log_likelihood = log_likelihood.stack(__sample__=("chain", "draw"))
    shape = log_likelihood.shape
    n_samples = shape[-1]
    n_data_points = int(np.prod(shape[:-1]))
    scale, scale_value = resolve_scale(scale)

    group_ids = np.asarray(group_ids)
    if len(group_ids) != n_data_points:
        raise ValueError(
            f"Length of group_ids ({len(group_ids)}) must match the number of "
            f"observations in log_likelihood ({n_data_points})."
        )
    unique_groups, group_index = np.unique(group_ids, return_inverse=True)
    n_groups = len(unique_groups)

    reff = compute_reff(inference_data, reff, n_samples)
    matrix, _, _ = as_sample_matrix(log_likelihood)  # (N, S)
    matrix = clean_log_likelihood(matrix, context="LOGO")

    try:
        method = method if isinstance(method, ISMethod) else ISMethod(method.lower())
    except ValueError:
        valid_methods = ", ".join(m.value for m in ISMethod)
        raise ValueError(f"Invalid method '{method}'. Must be one of: {valid_methods}")
    if method != ISMethod.PSIS:
        warnings.warn(
            f"Using {method.value.upper()} for LOGO computation. Note that PSIS is the "
            "recommended method as it is typically more efficient and reliable.",
            UserWarning,
            stacklevel=2,
        )

    index = torch.from_numpy(group_index.reshape(-1).astype(np.int64)).to(matrix.device)
    group_ll = matrix.new_zeros((n_groups, n_samples)).index_add_(0, index, matrix)
    del matrix

    return _logo_result(
        group_ll, unique_groups, n_samples, reff, scale, scale_value,
        method, pointwise,
    )


def _logo_result(
    group_ll, unique_groups, n_samples, reff, scale, scale_value,
    method, pointwise,
):
    """IS weighting and result assembly over the ``(n_groups, S)`` tensor of
    group sums.  PSIS takes the exact scorer whatever the precision."""
    n_groups = group_ll.shape[0]
    if method == ISMethod.PSIS:
        m_tail = tail_length(n_samples, reff)
        scores = apply_rowwise(lambda b: loo_scores_psis(b, m_tail), group_ll)
    elif method == ISMethod.SIS:
        scores = apply_rowwise(loo_scores_sis, group_ll)
    else:
        scores = apply_rowwise(loo_scores_tis, group_ll)
    elpd_g, diagnostics, lppd_g = map(_host, scores)

    warn_mg = False
    good_k = good_k_threshold(n_samples)
    if method == ISMethod.PSIS:
        if np.any(diagnostics > good_k):
            n_high_k = int(np.sum(diagnostics > good_k))
            warnings.warn(
                "Estimated shape parameter of Pareto distribution is greater than "
                f"{good_k:.2f} for {n_high_k} groups. This indicates that "
                "importance sampling may be unreliable because the marginal posterior "
                "and LOGO posterior are very different.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True
    else:
        min_ess = float(np.min(diagnostics))
        if min_ess < n_samples * 0.1:
            warnings.warn(
                f"Low effective sample size detected (minimum ESS: {min_ess:.1f}). This"
                " indicates that the importance sampling approximation may be"
                " unreliable. Consider using PSIS which is more robust to such cases.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True

    logo_lppd_i = DataArray(
        scale_value * elpd_g, ("group",), {"group": unique_groups}, "logo_i"
    )
    logo_lppd = float(logo_lppd_i.values.sum())
    logo_lppd_se = float((n_groups * np.var(logo_lppd_i.values)) ** 0.5)
    lppd = float(np.sum(lppd_g))
    p_logo = lppd - logo_lppd / scale_value
    p_logo_se = float(np.sqrt(np.sum(np.var(logo_lppd_i.values))))
    logoic = -2 * logo_lppd
    logoic_se = 2 * logo_lppd_se

    rows: list[tuple[str, Any]] = [
        ("elpd_logo", logo_lppd),
        ("se", logo_lppd_se),
        ("p_logo", p_logo),
        ("p_logo_se", p_logo_se),
        ("n_samples", n_samples),
        ("n_groups", n_groups),
        ("warning", warn_mg),
    ]
    if pointwise:
        rows.append(("logo_i", logo_lppd_i))
    rows += [("scale", scale), ("logoic", logoic), ("logoic_se", logoic_se)]
    if pointwise:
        if method == ISMethod.PSIS:
            rows += [("pareto_k", diagnostics), ("good_k", good_k)]
        else:
            rows += [("ess", diagnostics)]
    elif method == ISMethod.PSIS:
        rows += [("good_k", good_k)]

    return ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
