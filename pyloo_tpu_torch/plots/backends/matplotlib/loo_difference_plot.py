"""Matplotlib backend: pointwise ELPD difference vs a covariate."""

from __future__ import annotations

import matplotlib.pyplot as plt
import numpy as np

__all__ = ["plot_loo_difference"]


def plot_loo_difference(
    ax=None,
    x_values=None,
    diff=None,
    group=None,
    outlier_thresh=None,
    size=1,
    alpha=1,
    jitter=0,
    sort_by_group=False,
    figsize=None,
    textsize=None,
    backend_kwargs=None,
    show=None,
    **kwargs,
):
    """Scatter of elpd differences, colored by group, with outlier flags."""
    backend_kwargs = dict(backend_kwargs or {})
    if ax is None:
        backend_kwargs.setdefault("figsize", figsize)
        _, ax = plt.subplots(**backend_kwargs)

    x_values = np.asarray(x_values, dtype=float)
    diff = np.asarray(diff, dtype=float)

    if sort_by_group and group is not None:
        order = np.argsort(np.asarray(group), kind="stable")
        x_plot = np.arange(len(order), dtype=float)
        diff_plot = diff[order]
        group_plot = np.asarray(group)[order]
    else:
        x_plot = x_values.copy()
        diff_plot = diff
        group_plot = np.asarray(group) if group is not None else None

    rng = np.random.default_rng(0)
    jx, jy = (jitter, 0.0) if np.isscalar(jitter) else jitter
    if jx:
        x_plot = x_plot + rng.uniform(-jx, jx, size=len(x_plot))
    y_plot = diff_plot + (
        rng.uniform(-jy, jy, size=len(diff_plot)) if jy else 0.0
    )

    if group_plot is not None:
        for g in np.unique(group_plot):
            mask = group_plot == g
            ax.scatter(
                x_plot[mask], y_plot[mask], s=20 * size, alpha=alpha,
                label=str(g), **kwargs,
            )
        ax.legend(title="group")
    else:
        ax.scatter(x_plot, y_plot, s=20 * size, alpha=alpha, **kwargs)

    ax.axhline(0.0, color="grey", linewidth=1)

    if outlier_thresh is not None:
        outliers = np.abs(diff_plot) > outlier_thresh
        for xi, yi, i in zip(
            x_plot[outliers], y_plot[outliers], np.nonzero(outliers)[0]
        ):
            ax.annotate(str(i), (xi, yi), color="red", fontsize=9)
        ax.scatter(
            x_plot[outliers], y_plot[outliers], facecolors="none",
            edgecolors="red", s=60 * size, zorder=3,
        )

    ax.set_xlabel("x")
    ax.set_ylabel("ELPD difference")
    ax.set_title("Pointwise ELPD difference (model 1 - model 2)")
    if textsize is not None:
        for item in [ax.title, ax.xaxis.label, ax.yaxis.label]:
            item.set_fontsize(textsize)

    if show:
        plt.show()
    return ax
