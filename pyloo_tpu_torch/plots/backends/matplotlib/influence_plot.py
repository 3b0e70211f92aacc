"""Matplotlib backend: observation-influence bar chart."""

from __future__ import annotations

import matplotlib.pyplot as plt
import numpy as np

from ...plot_utils import host_values

__all__ = ["plot_influence"]


def plot_influence(
    ax=None,
    loo_results=None,
    var_name=None,
    figsize=None,
    textsize=None,
    color="C0",
    threshold=None,
    sort=True,
    n_points=10,
    use_pareto_k=True,
    k_threshold=0.7,
    backend_kwargs=None,
    show=None,
    **kwargs,
):
    """Bar chart of -loo_i (influence), optionally forcing in high-k points."""
    backend_kwargs = dict(backend_kwargs or {})
    if ax is None:
        backend_kwargs.setdefault("figsize", figsize)
        _, ax = plt.subplots(**backend_kwargs)

    if "loo_i" not in loo_results:
        raise ValueError(
            "loo_results does not contain pointwise values; recompute with"
            " pointwise=True"
        )
    loo_i = host_values(loo_results["loo_i"])
    influence = -loo_i
    idx = np.arange(len(influence))

    if sort:
        order = np.argsort(-influence)
    else:
        order = idx
    if n_points is not None:
        chosen = order[:n_points] if n_points > 0 else order[n_points:]
    else:
        chosen = order

    if use_pareto_k and "pareto_k" in loo_results:
        ks = host_values(loo_results["pareto_k"])
        forced = idx[ks > k_threshold]
        chosen = np.unique(np.concatenate([chosen, forced]))
        # keep influence ordering for display
        chosen = chosen[np.argsort(-influence[chosen])] if sort else chosen

    positions = np.arange(len(chosen))
    bar_colors = [color] * len(chosen)
    if use_pareto_k and "pareto_k" in loo_results:
        bar_colors = [
            "red" if ks[i] > k_threshold else color for i in chosen
        ]
    ax.bar(positions, influence[chosen], color=bar_colors, **kwargs)
    ax.set_xticks(positions)
    ax.set_xticklabels([str(i) for i in chosen], rotation=90)

    if threshold is not None:
        ax.axhline(threshold, color="red", linestyle="--", linewidth=1)

    ax.set_xlabel("Observation index")
    ax.set_ylabel("Influence (-elpd_i)")
    ax.set_title("Observation influence")
    if textsize is not None:
        for item in [ax.title, ax.xaxis.label, ax.yaxis.label]:
            item.set_fontsize(textsize)

    if show:
        plt.show()
    return ax
