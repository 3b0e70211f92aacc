"""Diagnostic plots (matplotlib backend, imported when a plot is drawn).

Counterpart of ``pyloo_tpu/plots``: the same facades, aliases and
matplotlib backends, drawn from this package's results on the host.
"""

from .compare_plot import plot_compare
from .influence_plot import plot_influence
from .loo_difference_plot import plot_loo_difference
from .loo_pit_plot import plot_loo_pit
from .loo_plot import plot_loo

# reference-compatible aliases (pyloo/__init__.py exports these names)
loo_plot = plot_loo
influence_plot = plot_influence
loo_difference_plot = plot_loo_difference
loo_pit_plot = plot_loo_pit
compare_plot = plot_compare
# arviz drop-in name: az.plot_khat(loo_result) is plot_loo's default view
# (Pareto-k scatter per observation)
plot_khat = plot_loo

__all__ = [
    "plot_loo",
    "plot_compare",
    "plot_influence",
    "plot_loo_difference",
    "plot_loo_pit",
    "compare_plot",
    "plot_khat",
    "loo_plot",
    "influence_plot",
    "loo_difference_plot",
    "loo_pit_plot",
]
