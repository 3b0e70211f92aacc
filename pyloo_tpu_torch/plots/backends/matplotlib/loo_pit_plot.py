"""Matplotlib backend: LOO-PIT calibration vs Uniform(0, 1)."""

from __future__ import annotations

import matplotlib.pyplot as plt
import numpy as np

__all__ = ["plot_loo_pit"]


def plot_loo_pit(
    ax=None,
    pit=None,
    kind="ecdf",
    figsize=None,
    textsize=None,
    color="C0",
    n_bins=None,
    backend_kwargs=None,
    show=None,
    **kwargs,
):
    backend_kwargs = dict(backend_kwargs or {})
    if ax is None:
        backend_kwargs.setdefault("figsize", figsize)
        _, ax = plt.subplots(**backend_kwargs)

    pit = np.asarray(pit, dtype=float).ravel()
    n = len(pit)

    if kind == "ecdf":
        xs = np.sort(pit)
        ys = np.arange(1, n + 1) / n
        ax.step(xs, ys, where="post", color=color, label="LOO-PIT ECDF",
                **kwargs)
        grid = np.linspace(0, 1, 101)
        ax.plot(grid, grid, color="gray", linestyle="--", linewidth=1,
                label="Uniform")
        # 95% Dvoretzky-Kiefer-Wolfowitz simultaneous band around uniform
        eps = np.sqrt(np.log(2 / 0.05) / (2 * max(n, 1)))
        ax.fill_between(
            grid,
            np.clip(grid - eps, 0, 1),
            np.clip(grid + eps, 0, 1),
            color="gray",
            alpha=0.2,
            label="95% DKW band",
        )
        ax.set_xlabel("LOO-PIT value")
        ax.set_ylabel("Empirical CDF")
    else:  # hist
        if n_bins is None:
            n_bins = max(int(np.ceil(np.sqrt(n))), 5)
        ax.hist(pit, bins=np.linspace(0, 1, n_bins + 1), density=True,
                color=color, alpha=0.8, edgecolor="white", **kwargs)
        ax.axhline(1.0, color="gray", linestyle="--", linewidth=1,
                   label="Uniform density")
        ax.set_xlabel("LOO-PIT value")
        ax.set_ylabel("Density")

    ax.set_xlim(-0.02, 1.02)
    ax.set_title("LOO-PIT calibration")
    ax.legend()

    if textsize is not None:
        for item in [ax.title, ax.xaxis.label, ax.yaxis.label]:
            item.set_fontsize(textsize)
    if show:
        plt.show()
    return ax
