"""The matrix function's device milliseconds a chunk of draws: the device
operations launched under the benchmark's generator range."""

from benchmark.measure import generator_ms_per_chunk as read  # noqa: F401
