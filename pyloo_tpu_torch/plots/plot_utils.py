"""Plotting helpers: backend dispatch, figure sizing, number formatting.

Counterpart of ``pyloo_tpu/plots/plot_utils.py`` (reference
``pyloo/plots/plot_utils.py``).  Backends load from this package's own
``plots.backends``; matplotlib is imported when a backend is loaded, never
at package import.
"""

from __future__ import annotations

import importlib
import warnings

import numpy as np
import torch

from ..rcparams import rcParams

__all__ = [
    "get_plotting_function",
    "_scale_fig_size",
    "default_grid",
    "format_sig_figs",
    "round_num",
    "vectorized_to_hex",
    "host_values",
]


def host_values(values) -> np.ndarray:
    """A result's values (array-like, DataArray or tensor) as a flat numpy
    array on the host."""
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy().ravel()
    return np.asarray(getattr(values, "values", values)).ravel()


def _scale_fig_size(figsize, textsize, rows=1, cols=1):
    """Derive (figsize, labelsize, linewidth) defaults from grid shape."""
    if figsize is None:
        width = 8 + (cols - 1) * 4
        height = 5 + (rows - 1) * 2.5
        figsize = (width, height)
    if textsize is None:
        textsize = 12
    scale = (figsize[0] / (8 * cols)) ** 0.5
    labelsize = textsize * scale
    linewidth = max(1.0, scale)
    return figsize, labelsize, linewidth


def default_grid(n_items, grid=None, max_cols=4, min_cols=3):
    """Rows/cols layout for n_items panels."""
    if grid is not None:
        rows, cols = grid
        if rows * cols < n_items:
            raise ValueError("The number of rows times columns is less than the number of subplots")
        if rows * cols - n_items >= max(rows, cols):
            warnings.warn(
                "The number of rows times columns is larger than necessary",
                UserWarning,
                stacklevel=2,
            )
        return rows, cols
    cols = min(n_items, max_cols) if n_items > min_cols else n_items
    rows = int(np.ceil(n_items / cols))
    return rows, cols


def get_plotting_function(plot_name, plot_module, backend):
    """Resolve a backend plotting function by name."""
    aliases = {"mpl": "matplotlib", "matplotlib": "matplotlib"}
    if backend is None:
        backend = rcParams["plot.backend"]
    backend = backend.lower()
    try:
        backend = aliases[backend]
    except KeyError as err:
        raise KeyError(
            f"Backend {backend} is not implemented. Try backend in"
            f" {set(aliases.values())}"
        ) from err
    module = importlib.import_module(
        f"{__package__}.backends.{backend}.{plot_module}"
    )
    return getattr(module, plot_name)


def format_sig_figs(value, default=None):
    """Significant figures: the integer-part width or ``default``."""
    if default is None:
        default = 2
    if value == 0:
        return 1
    return max(int(np.log10(np.abs(value))) + 1, default)


def round_num(n, round_to):
    """Round to ``round_to`` significant figures, returned as a string."""
    sig_figs = format_sig_figs(n, round_to)
    return f"{n:.{sig_figs}g}"


def vectorized_to_hex(values, keep_alpha=False):
    """Convert color spec(s) to hex strings."""
    from matplotlib.colors import to_hex

    if isinstance(values, str):
        return to_hex(values, keep_alpha)
    return [to_hex(v, keep_alpha) for v in np.atleast_1d(values)]
