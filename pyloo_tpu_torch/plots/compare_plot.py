"""Model-comparison plot facade (arviz ``plot_compare`` idiom).

Counterpart of ``pyloo_tpu/plots/compare_plot.py``: the plot of a
:func:`pyloo_tpu_torch.loo_compare` table, a :class:`CompareTable` or its
``to_pandas()`` DataFrame (no reference plot analogue).
"""

from __future__ import annotations

from ..rcparams import rcParams
from .plot_utils import _scale_fig_size, get_plotting_function

__all__ = ["plot_compare"]


def plot_compare(
    comp_df,
    plot_standard_error=True,
    plot_ic_diff=True,
    order_by_rank=True,
    legend=True,
    title=True,
    figsize=None,
    textsize=None,
    color="k",
    backend=None,
    backend_kwargs=None,
    show=None,
    ax=None,
    **kwargs,
):
    """Forest plot of a :func:`pyloo_tpu_torch.compare` result.

    One row per model (best at the top): the ELPD point estimate with its
    standard-error bar, the pairwise difference to the best model with its
    dSE bar on an offset row, and a vertical reference line at the best
    model's ELPD.

    Parameters
    ----------
    comp_df : CompareTable or pandas.DataFrame
        Output of :func:`pyloo_tpu_torch.compare` / :func:`loo_compare`, or
        its ``to_pandas()``.
    plot_standard_error : bool
        Draw SE bars on the point estimates.
    plot_ic_diff : bool
        Draw the elpd-difference rows (triangles) with dSE bars.
    order_by_rank : bool
        Sort rows by the ``rank`` column (best first).

    Returns
    -------
    matplotlib Axes
    """
    if backend is None:
        backend = rcParams["plot.backend"]
    backend = backend.lower()

    backend_fn = get_plotting_function("plot_compare", "compare_plot", backend)
    if ax is None and figsize is None:
        figsize, *_ = _scale_fig_size(figsize, textsize)

    return backend_fn(
        ax=ax,
        comp_df=comp_df,
        plot_standard_error=plot_standard_error,
        plot_ic_diff=plot_ic_diff,
        order_by_rank=order_by_rank,
        legend=legend,
        title=title,
        figsize=figsize,
        textsize=textsize,
        color=color,
        backend_kwargs=backend_kwargs,
        show=show,
        **kwargs,
    )
