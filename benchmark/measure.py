"""The arithmetic the metric readers share: rates, shares and rooflines.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W (dense
rates): a card set below that limit runs slower under load, so every run
prints the card's power limit beside its numbers.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # HBM3
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores (TF32 is off)
KERNEL_A = "loo_prepass_kernel"  # kernel A's name in the device trace


def rate(rows_per_call: int, walls: list) -> float:
    """Rows of every call over the calls' summed wall."""
    return rows_per_call * len(walls) / sum(walls)


def least_seconds(n_bytes: float, flops: float) -> float:
    """The least time the chip needs for the work: the larger of its bytes
    at the HBM rate and its operations at the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def roofline_pct(n_bytes: float, flops: float, seconds: float) -> float | None:
    """The work's least time as a share of the time it took, in %."""
    return 100.0 * least_seconds(n_bytes, flops) / seconds if seconds > 0 else None


def idle_pct(trace) -> float | None:
    """The share of the traced window in which the run's devices ran
    nothing, averaged over them, in %; None with no device operation."""
    if trace is None or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.mean_busy_us() / trace.window_us)


def per_chunk(total: float, ctx) -> float:
    """``total`` over the traced calls' chunks, as the program made them:
    the generator's calls over the calls it takes for a chunk (one a shard
    of the cell's mesh)."""
    return total * ctx.case.generator_calls_per_chunk / ctx.trace.generator_calls


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def is_kernel_a(name: str) -> bool:
    return KERNEL_A in name


# the readers of ``metrics/``: each takes the run's window (``core.Window``)
# and returns its number, or None where it finds nothing to read


def rate_of(ctx) -> float:
    """Observations the window's calls estimated over the calls' summed wall."""
    return rate(ctx.case.rows_per_call, ctx.walls)


def traced(ctx):
    """The traced window, or None where no device operation was traced."""
    return ctx.trace if ctx.trace is not None and ctx.trace.ops else None


def chunked(ctx):
    """The traced window, or None where no device operation or no call of
    the generator was traced (no chunk to count)."""
    t = traced(ctx)
    return t if t and t.generator_calls else None


def generator_ms_per_chunk(ctx) -> float | None:
    """Device milliseconds a chunk under the benchmark's generator range."""
    t = chunked(ctx)
    return per_chunk(t.generator_us, ctx) / 1e3 if t and t.generator_ops else None


def outside_generator_ms_per_chunk(ctx) -> float | None:
    """Device milliseconds a chunk outside the benchmark's generator range."""
    t = chunked(ctx)
    return per_chunk(t.op_us() - t.generator_us, ctx) / 1e3 if t else None


def call_mfu(ctx) -> float | None:
    """The least time the call's work needs at the chip's peaks (its bytes at
    the HBM rate or its operations at the float32 rate, the longer) over a
    traced call's wall, in %."""
    t = traced(ctx)
    if t is None:
        return None
    return roofline_pct(ctx.case.call_bytes, ctx.case.call_flops, t.window_us / 1e6 / t.calls)


def device_idle_share(ctx) -> float | None:
    return idle_pct(ctx.trace)
