"""Matplotlib backend: model-comparison forest plot over ``compare()``.

Renders the table produced by :func:`pyloo_tpu_torch.compare` (a
:class:`CompareTable`, or its ``to_pandas()`` DataFrame; columns
``rank`` / ``elpd_<ic>`` / ``elpd_diff`` / ``se`` / ``dse``) in the arviz
``plot_compare`` idiom: one row per model, ELPD point estimates with
standard-error bars, and — offset below each non-best row — the pairwise
difference to the best model with its dSE bar, anchored by a vertical line
at the best model's ELPD.
"""

from __future__ import annotations

import matplotlib.pyplot as plt
import numpy as np

__all__ = ["plot_compare"]


def plot_compare(
    ax=None,
    comp_df=None,
    plot_standard_error=True,
    plot_ic_diff=True,
    order_by_rank=True,
    legend=True,
    title=True,
    figsize=None,
    textsize=None,
    color="k",
    backend_kwargs=None,
    show=None,
    **kwargs,
):
    backend_kwargs = dict(backend_kwargs or {})
    if ax is None:
        backend_kwargs.setdefault("figsize", figsize)
        _, ax = plt.subplots(**backend_kwargs)

    ic_cols = [
        c
        for c in comp_df.columns
        if c.startswith("elpd_") and c != "elpd_diff"
    ]
    if not ic_cols:
        raise ValueError(
            "comp_df does not look like a compare() result: no elpd_<ic>"
            f" column among {list(comp_df.columns)}"
        )
    ic = ic_cols[0]

    # rows in rank order without pandas: a CompareTable has no sort_values
    rank = np.asarray(comp_df["rank"], dtype=int)
    order = np.argsort(rank, kind="stable") if order_by_rank else np.arange(len(rank))
    names = [list(comp_df.index)[i] for i in order]
    n = len(names)

    def column(name, dtype=float):
        return np.asarray(comp_df[name], dtype=dtype)[order]

    elpd = column(ic)
    se = column("se")
    dse = column("dse")
    best_idx = int(rank[order].argmin())

    # best model at the top; each model's diff marker sits half a step below
    yticks = np.arange(n, 0, -1, dtype=float)
    step = 0.5

    if plot_standard_error:
        ax.errorbar(
            elpd,
            yticks,
            xerr=se,
            fmt="o",
            color=color,
            mfc="none",
            capsize=3,
            label=ic.replace("_", " "),
            **kwargs,
        )
    else:
        ax.plot(elpd, yticks, "o", color=color, mfc="none", **kwargs)

    if plot_ic_diff and n > 1:
        mask = np.arange(n) != best_idx
        # diff rows carry the model's own point estimate with the dSE bar:
        # elpd_diff is signed (model - best on log scale, flipped on
        # deviance/negative_log), so reconstructing "best - diff" lands on
        # the wrong side of the best-model line for half the scales.  The
        # model's own elpd is sign-convention-proof and visually identical
        # whenever diff == elpd - best (always true on the native scale).
        ax.errorbar(
            elpd[mask],
            yticks[mask] - step,
            xerr=dse[mask],
            fmt="^",
            color="grey",
            capsize=3,
            label="elpd difference\n(vs best, +dSE)",
        )

    ax.axvline(
        elpd[best_idx],
        linestyle="--",
        color="grey",
        linewidth=1,
        label="best model",
    )

    ax.set_yticks(yticks)
    ax.set_yticklabels(names)
    ax.set_ylim(0.5 - step, n + step)
    scale = str(column("scale", object)[0]) if "scale" in comp_df.columns else "log"
    ax.set_xlabel(f"{ic.replace('_', ' ')} ({scale} scale)")
    if title:
        ax.set_title(
            f"Model comparison\nhigher {ic.replace('_', ' ')} is better"
            if scale == "log"
            else f"Model comparison\nlower {ic.replace('_', ' ')} is better"
        )
    if legend:
        ax.legend(loc="best", fontsize=textsize)
    if textsize is not None:
        ax.tick_params(labelsize=textsize)
    if show:
        plt.show()
    return ax
