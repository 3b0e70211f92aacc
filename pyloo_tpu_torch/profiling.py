"""Profiling and throughput instrumentation.

Counterpart of ``pyloo_tpu/profiling.py``: :func:`trace` records a
``torch.profiler`` trace (the host, and the CUDA device when the
computation device is one) and writes it into a directory as a Chrome
trace (open it in ``chrome://tracing`` or Perfetto); :func:`annotate` names
a region in it; :class:`Throughput` measures wall-clock rates
(observations a second) around device work.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from ._common import compute_device

__all__ = ["trace", "Throughput", "annotate"]


@contextmanager
def trace(log_dir: str):
    """Record a profile of the block into ``log_dir`` as a Chrome trace.

    The host's operations are always recorded; the CUDA device's kernels
    and copies too when ``rcParams["device.device"]`` is ``"cuda"``.  The
    file is ``log_dir/trace_<pid>_<n>.json``; the block's end waits for the
    device's queued work, so its kernels are in the trace.  A block that
    raises still writes its trace, and the exception goes on.

    >>> with trace("/tmp/loo-trace"):
    ...     loo(idata)
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = compute_device().type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.synchronize()
    finally:
        n = len([name for name in os.listdir(log_dir)
                 if name.startswith(f"trace_{os.getpid()}_")])
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


def annotate(name: str):
    """Named region that shows up in profiler traces (``record_function``)."""
    return torch.profiler.record_function(name)


@dataclass
class Throughput:
    """Throughput counter over timed laps.

    It does not wait for the device by itself: end each lap with a
    synchronisation, as here.

    >>> meter = Throughput()
    >>> with meter.measure(n_items=batch.shape[0]):
    ...     out = kernel(batch)
    ...     torch.cuda.synchronize()
    >>> meter.items_per_sec
    """

    total_items: int = 0
    total_seconds: float = 0.0
    laps: list = field(default_factory=list)

    @contextmanager
    def measure(self, n_items: int):
        start = time.perf_counter()
        yield
        elapsed = time.perf_counter() - start
        self.total_items += n_items
        self.total_seconds += elapsed
        self.laps.append((n_items, elapsed))

    @property
    def items_per_sec(self) -> float:
        if self.total_seconds == 0:
            return 0.0
        return self.total_items / self.total_seconds

    def summary(self, unit: str = "obs") -> str:
        return (
            f"{self.total_items} {unit} in {self.total_seconds:.3f}s "
            f"({self.items_per_sec:,.0f} {unit}/s over {len(self.laps)} laps)"
        )
