"""The whole call's share of the chip's peak, in %: the least time its work
needs (the log-likelihood written once and read once and the model's rows
read once at the HBM rate, or the generator's matmuls at the float32 rate,
whichever is longer) over a traced call's wall.  The same work whatever
implements it, so it bounds every kernel's gain."""

from benchmark.measure import call_mfu as read  # noqa: F401
