"""Widely applicable information criterion (WAIC).

Counterpart of ``pyloo_tpu/waic.py`` (reference ``pyloo/waic.py:16-207``);
the per-row lppd and variance run on the device in row chunks.
"""

from __future__ import annotations

import warnings

import numpy as np

from ._common import clean_log_likelihood, resolve_scale
from .base import _host, as_sample_matrix
from .containers import DataArray
from .elpd import ELPDData
from .ops.loo_kernels import waic_scores
from .parallel import apply_rowwise
from .rcparams import rcParams
from .utils import get_log_likelihood, to_inference_data

__all__ = ["waic"]


def waic(
    data,
    pointwise: bool | None = None,
    var_name: str | None = None,
    scale: str | None = None,
) -> ELPDData:
    """Compute WAIC: ``waic_i = scale * (lppd_i - var_draws(ll_i))``.

    Warns when any pointwise posterior variance of the log predictive
    densities exceeds 0.4 (WAIC starting to fail).

    Returns
    -------
    ELPDData
        Rows ``elpd_waic``/``se``/``p_waic`` (+ ``waic_i`` when pointwise).
    """
    inference_data = to_inference_data(data)
    log_likelihood = get_log_likelihood(inference_data, var_name=var_name)
    pointwise = rcParams["stats.ic_pointwise"] if pointwise is None else pointwise

    log_likelihood = log_likelihood.stack(__sample__=("chain", "draw"))
    shape = log_likelihood.shape
    n_samples = shape[-1]
    n_data_points = int(np.prod(shape[:-1]))
    scale, scale_value = resolve_scale(scale)

    matrix, _, _ = as_sample_matrix(log_likelihood)
    matrix = clean_log_likelihood(matrix, context="WAIC", clean_inf=True)
    lppd_i, vars_lpd = map(_host, apply_rowwise(waic_scores, matrix))
    del matrix

    warn_mg = bool(np.any(vars_lpd > 0.4))
    if warn_mg:
        warnings.warn(
            "For one or more samples the posterior variance of the log predictive "
            "densities exceeds 0.4. This could be indication of WAIC starting to fail.",
            UserWarning,
            stacklevel=2,
        )

    obs_dims = tuple(d for d in log_likelihood.dims if d != "__sample__")
    obs_coords = {d: c for d, c in log_likelihood.coords.items() if d in obs_dims}
    obs_shape = tuple(log_likelihood.sizes[d] for d in obs_dims)

    waic_i = scale_value * (lppd_i - vars_lpd)
    waic_se = float((n_data_points * np.var(waic_i)) ** 0.5)
    waic_sum = float(np.sum(waic_i))
    p_waic = float(np.sum(vars_lpd))

    rows = [
        ("elpd_waic", waic_sum),
        ("se", waic_se),
        ("p_waic", p_waic),
        ("n_samples", n_samples),
        ("n_data_points", n_data_points),
        ("warning", warn_mg),
    ]
    if pointwise:
        if np.allclose(waic_i, waic_i.flat[0]):
            warnings.warn(
                "The point-wise WAIC is the same with the sum WAIC, please double check "
                "the Observed RV in your model to make sure it returns element-wise logp.",
                UserWarning,
                stacklevel=2,
            )
        rows.append(
            ("waic_i", DataArray(waic_i.reshape(obs_shape), obs_dims, obs_coords, "waic_i"))
        )
    rows.append(("scale", scale))
    return ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
