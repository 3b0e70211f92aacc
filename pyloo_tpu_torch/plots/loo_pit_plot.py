"""LOO-PIT calibration plot facade (counterpart of
``pyloo_tpu/plots/loo_pit_plot.py``; no reference analogue — companion to
:func:`pyloo_tpu_torch.loo_pit`)."""

from __future__ import annotations

from ..rcparams import rcParams
from .plot_utils import _scale_fig_size, get_plotting_function, host_values

__all__ = ["plot_loo_pit"]


def plot_loo_pit(
    pit=None,
    data=None,
    *,
    y=None,
    y_hat=None,
    var_name=None,
    reff=None,
    kind="ecdf",
    figsize=None,
    textsize=None,
    color="C0",
    n_bins=None,
    backend=None,
    backend_kwargs=None,
    show=None,
    ax=None,
    **kwargs,
):
    """Plot LOO-PIT values against the Uniform(0, 1) reference.

    ``kind="ecdf"`` draws the empirical CDF of the PIT values with the
    uniform diagonal and a 95% Dvoretzky-Kiefer-Wolfowitz band;
    ``kind="hist"`` draws a density histogram with the uniform level line.

    Pass precomputed ``pit`` values (from :func:`pyloo_tpu_torch.loo_pit`) or the
    ``data``/``y``/``y_hat`` inputs to compute them here.
    """
    if pit is None:
        if data is None:
            raise ValueError("plot_loo_pit needs `pit` values or `data`")
        from ..diagnostics import loo_pit

        pit = loo_pit(data, y=y, y_hat=y_hat, var_name=var_name, reff=reff)
    pit = host_values(pit)
    if kind not in ("ecdf", "hist"):
        raise ValueError(f"kind must be 'ecdf' or 'hist', got {kind!r}")

    if backend is None:
        backend = rcParams["plot.backend"]
    backend_fn = get_plotting_function(
        "plot_loo_pit", "loo_pit_plot", backend.lower()
    )
    if ax is None and figsize is None:
        figsize, *_ = _scale_fig_size(figsize, textsize)
    return backend_fn(
        ax=ax,
        pit=pit,
        kind=kind,
        figsize=figsize,
        textsize=textsize,
        color=color,
        n_bins=n_bins,
        backend_kwargs=backend_kwargs,
        show=show,
        **kwargs,
    )
