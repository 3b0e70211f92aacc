"""The LPD pass's device milliseconds a chunk: every device operation's
time outside the benchmark's generator range (the sampled rows' exact
scoring included)."""

from benchmark.measure import outside_generator_ms_per_chunk as read  # noqa: F401
