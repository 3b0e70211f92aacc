"""The factorisation layer's device milliseconds a chunk of draws: every
device operation outside the benchmark's generator range (the Cholesky
factorisation, the inverse factor, the conditional densities, and the
float64 PSIS of the call shared over its chunks)."""

from benchmark.measure import outside_generator_ms_per_chunk as read  # noqa: F401
