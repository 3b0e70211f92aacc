"""LOO diagnostics plot facade (reference ``pyloo/plots/loo_plot.py``)."""

from __future__ import annotations

from ..rcparams import rcParams
from .plot_utils import _scale_fig_size, get_plotting_function

__all__ = ["plot_loo"]


def plot_loo(
    loo_results,
    var_name=None,
    figsize=None,
    textsize=None,
    color="C0",
    threshold=None,
    show_pareto_k=True,
    show_elpd=False,
    backend=None,
    backend_kwargs=None,
    show=None,
    ax=None,
    style=None,
    **kwargs,
):
    """Scatter plot of Pareto k values (or pointwise ELPD) per observation.

    ``threshold`` draws the k warning line and highlights exceedances;
    ``show_elpd=True`` plots pointwise elpd instead.
    """
    if backend is None:
        backend = rcParams["plot.backend"]
    backend = backend.lower()

    backend_fn = get_plotting_function("plot_loo", "loo_plot", backend)
    if ax is None and figsize is None:
        figsize, *_ = _scale_fig_size(figsize, textsize)
    if show_elpd:
        show_pareto_k = False

    return backend_fn(
        ax=ax,
        loo_results=loo_results,
        var_name=var_name,
        figsize=figsize,
        textsize=textsize,
        color=color,
        threshold=threshold,
        show_pareto_k=show_pareto_k,
        show_elpd=show_elpd,
        backend_kwargs=backend_kwargs,
        show=show,
        **kwargs,
    )
