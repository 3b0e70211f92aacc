"""The share of the traced window in which the run's cards ran no
operation, averaged over the cards, in %."""

from benchmark.measure import device_idle_share as read  # noqa: F401
