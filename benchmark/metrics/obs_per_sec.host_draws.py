"""Observations the window's calls estimated over the calls' summed wall
(host clock, each call ending in a synchronise of every card)."""

from benchmark.measure import rate_of as read  # noqa: F401
