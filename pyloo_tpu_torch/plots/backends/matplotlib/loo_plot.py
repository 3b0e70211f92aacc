"""Matplotlib backend: Pareto-k / ELPD scatter diagnostics."""

from __future__ import annotations

import matplotlib.pyplot as plt
import numpy as np

from ...plot_utils import host_values

__all__ = ["plot_loo"]


def _pointwise(loo_results, key):
    return host_values(loo_results[key])


def plot_loo(
    ax=None,
    loo_results=None,
    var_name=None,
    figsize=None,
    textsize=None,
    color="C0",
    threshold=None,
    show_pareto_k=True,
    show_elpd=False,
    backend_kwargs=None,
    show=None,
    **kwargs,
):
    """Scatter of per-observation Pareto k (or pointwise elpd) values."""
    backend_kwargs = dict(backend_kwargs or {})
    if ax is None:
        backend_kwargs.setdefault("figsize", figsize)
        _, ax = plt.subplots(**backend_kwargs)

    if show_elpd:
        key = "loo_i" if "loo_i" in loo_results else "waic_i"
        values = _pointwise(loo_results, key)
        ylabel = "ELPD"
        title = "Pointwise ELPD (LOO)"
    else:
        if "pareto_k" not in loo_results:
            raise ValueError(
                "loo_results does not contain pareto_k values; recompute with"
                " pointwise=True"
            )
        values = _pointwise(loo_results, "pareto_k")
        ylabel = "Pareto k"
        title = "Pareto k diagnostics"

    x = np.arange(len(values))
    ax.scatter(x, values, c=color, **kwargs)

    if threshold is not None and not show_elpd:
        ax.axhline(threshold, color="red", linestyle="--", linewidth=1,
                   label=f"threshold = {threshold:.2f}")
        high = values > threshold
        if high.any():
            ax.scatter(x[high], values[high], c="red", zorder=3)
        ax.legend()

    ax.set_xlabel("Observation index")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    if textsize is not None:
        for item in [ax.title, ax.xaxis.label, ax.yaxis.label]:
            item.set_fontsize(textsize)

    if show:
        plt.show()
    return ax
