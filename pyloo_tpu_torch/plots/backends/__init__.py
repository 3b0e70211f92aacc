"""Plot backend implementations, loaded by ``plot_utils.get_plotting_function``."""
