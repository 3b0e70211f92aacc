"""Observation-influence plot facade (reference ``pyloo/plots/influence_plot.py``)."""

from __future__ import annotations

from ..rcparams import rcParams
from .plot_utils import _scale_fig_size, get_plotting_function

__all__ = ["plot_influence"]


def plot_influence(
    loo_results,
    var_name=None,
    figsize=None,
    textsize=None,
    color="C0",
    threshold=None,
    sort=True,
    n_points=10,
    use_pareto_k=True,
    k_threshold=0.7,
    backend=None,
    backend_kwargs=None,
    show=None,
    ax=None,
    style=None,
    **kwargs,
):
    """Bar chart of the most influential observations (-elpd_i).

    ``n_points`` selects the top (positive) or bottom (negative) points;
    observations with Pareto k above ``k_threshold`` are force-included and
    highlighted when ``use_pareto_k``.
    """
    if backend is None:
        backend = rcParams["plot.backend"]
    backend = backend.lower()

    backend_fn = get_plotting_function("plot_influence", "influence_plot", backend)
    if ax is None and figsize is None:
        figsize, *_ = _scale_fig_size(figsize, textsize)

    return backend_fn(
        ax=ax,
        loo_results=loo_results,
        var_name=var_name,
        figsize=figsize,
        textsize=textsize,
        color=color,
        threshold=threshold,
        sort=sort,
        n_points=n_points,
        use_pareto_k=use_pareto_k,
        k_threshold=k_threshold,
        backend_kwargs=backend_kwargs,
        show=show,
        **kwargs,
    )
