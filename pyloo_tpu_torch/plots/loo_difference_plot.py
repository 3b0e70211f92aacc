"""ELPD-difference plot facade (reference ``pyloo/plots/loo_difference_plot.py``)."""

from __future__ import annotations

import numpy as np

from ..rcparams import rcParams
from .plot_utils import _scale_fig_size, get_plotting_function, host_values

__all__ = ["plot_loo_difference"]


def plot_loo_difference(
    x_values,
    loo_results_1,
    loo_results_2,
    group=None,
    outlier_thresh=None,
    size=1,
    alpha=1,
    jitter=0,
    sort_by_group=False,
    figsize=None,
    textsize=None,
    backend=None,
    backend_kwargs=None,
    show=None,
    ax=None,
    style=None,
    **kwargs,
):
    """Pointwise elpd difference of two models against a covariate.

    Points can be colored by ``group``, jittered, and flagged when the
    absolute difference exceeds ``outlier_thresh``.
    """
    if backend is None:
        backend = rcParams["plot.backend"]
    backend = backend.lower()

    def pointwise(res):
        for key in ("loo_i", "waic_i", "kfold_i"):
            if key in res:
                return host_values(res[key])
        raise ValueError(
            "Results do not contain pointwise values; recompute with"
            " pointwise=True"
        )

    diff = pointwise(loo_results_1) - pointwise(loo_results_2)
    x_values = np.asarray(x_values)
    if len(x_values) != len(diff):
        raise ValueError(
            f"x_values length ({len(x_values)}) must match the number of"
            f" observations ({len(diff)})"
        )
    if group is not None and len(np.asarray(group)) != len(x_values):
        raise ValueError("group must be the same length as x_values")

    backend_fn = get_plotting_function(
        "plot_loo_difference", "loo_difference_plot", backend
    )
    if ax is None and figsize is None:
        figsize, *_ = _scale_fig_size(figsize, textsize)

    return backend_fn(
        ax=ax,
        x_values=x_values,
        diff=diff,
        group=group,
        outlier_thresh=outlier_thresh,
        size=size,
        alpha=alpha,
        jitter=jitter,
        sort_by_group=sort_by_group,
        figsize=figsize,
        textsize=textsize,
        backend_kwargs=backend_kwargs,
        show=show,
        **kwargs,
    )
