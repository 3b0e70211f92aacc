"""Generic ELPD for held-out (test) data, as R's ``loo::elpd()``.

Counterpart of ``pyloo_tpu/generic_elpd.py``: the expected log pointwise
predictive density of a log-likelihood matrix evaluated on data the
posterior never saw,

    elpd_i = logsumexp_s ll[i, s] - log S

One log-sum-exp per row on the device, in row chunks and in the configured
precision; no importance weighting is involved.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ._common import clean_log_likelihood, resolve_scale
from .base import _host, as_sample_matrix
from .containers import DataArray
from .elpd import ELPDData
from .ops.lse import logsumexp
from .parallel import apply_rowwise
from .rcparams import rcParams
from .utils import get_log_likelihood, to_inference_data

__all__ = ["elpd"]


def elpd(
    data,
    *,
    var_name: str | None = None,
    scale: str | None = None,
    pointwise: bool | None = None,
) -> ELPDData:
    """Expected log pointwise predictive density of held-out data.

    Parameters
    ----------
    data : InferenceData-convertible
        Must carry a log-likelihood group evaluated at the *test*
        observations under draws from a posterior fit on training data.
    var_name : str, optional
        Log-likelihood variable when several are stored.
    scale : str, optional
        "log" (default), "negative_log", or "deviance".
    pointwise : bool, optional
        Include per-observation ``elpd_i`` (defaults to
        ``rcParams["stats.ic_pointwise"]``).

    Returns
    -------
    ELPDData
        Rows ``elpd``/``se``/``ic``/``ic_se`` (``ic = -2 elpd``), plus
        pointwise values when requested.
    """
    pointwise = rcParams["stats.ic_pointwise"] if pointwise is None else pointwise
    scale, scale_value = resolve_scale(scale)

    inference_data = to_inference_data(data)
    log_likelihood = get_log_likelihood(inference_data, var_name=var_name)
    log_likelihood = log_likelihood.stack(__sample__=("chain", "draw"))
    shape = log_likelihood.shape
    n_samples = shape[-1]
    n_data_points = int(np.prod(shape[:-1]))

    matrix, _, _ = as_sample_matrix(log_likelihood)
    matrix = clean_log_likelihood(matrix, context="ELPD")
    (lse,) = apply_rowwise(lambda block: (logsumexp(block, dim=1),), matrix)
    lpd_i = _host(lse) - np.log(n_samples)
    elpd_i = DataArray(
        scale_value * lpd_i,
        ("obs",),
        {"obs": np.arange(n_data_points)},
        "elpd_i",
    )
    total = float(elpd_i.values.sum())
    se = float((n_data_points * np.var(elpd_i.values)) ** 0.5)

    rows: list[tuple[str, Any]] = [
        ("elpd", total),
        ("se", se),
        ("ic", -2 * total),
        ("ic_se", 2 * se),
        ("n_samples", n_samples),
        ("n_data_points", n_data_points),
        ("warning", False),
    ]
    if pointwise:
        rows.append(("elpd_i", elpd_i))
    rows.append(("scale", scale))
    return ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
