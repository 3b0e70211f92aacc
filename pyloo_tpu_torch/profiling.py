"""Profiling and throughput instrumentation.

Counterpart of ``pyloo_tpu/profiling.py``: :func:`trace` records a
``torch.profiler`` trace (the host, and the CUDA device when the
computation device is one) and writes it into a directory as a Chrome
trace (open it in ``chrome://tracing`` or Perfetto); :func:`annotate` names
a region in it; :class:`Throughput` measures wall-clock rates
(observations a second) around device work.

The package's own spans and counters record only while a torch profiler
records, :func:`trace` or any other: :func:`span` names a phase of an entry
point (``pyloo.loo.ingest``, ``pyloo.chunk.score``, ...) as a host range in
the profiler's trace, on the clock of the device's activity, and
:func:`count` adds to a counter (``host_reads`` by the funnel that read,
``h2d_bytes`` by what was copied, ``guard_reruns``, ``factor_draws`` and
``factor_failures`` by form), which :func:`counters` reads.  With no profiler recording, each costs one check of
the profiler's state.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

__all__ = ["trace", "Throughput", "annotate", "span", "count", "counters", "reset_counters"]

_recording = torch._C._autograd._profiler_enabled
# a host range of the profiler's own kind (not a user annotation, which the
# profiler mirrors onto the device's timeline as a range of its own); its
# keyword values are the event's args in the trace
_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()
_COUNTERS: dict = {}
_COUNTERS_LOCK = threading.Lock()


def span(name: str, **args):
    """The phase ``name`` as a host range of the profiler's trace, with
    ``args`` (the chunk ``c``, the shard ``j``) as the event's args; a
    shared no-op context when no profiler records."""
    if not _recording():
        return _OFF
    return _range(name, keyword_values=args)


def count(counter: str, key: str, n: int = 1) -> None:
    """Add ``n`` to ``counter[key]`` while a profiler records."""
    if not _recording():
        return
    with _COUNTERS_LOCK:
        per = _COUNTERS.setdefault(counter, {})
        per[key] = per.get(key, 0) + n


def counters() -> dict:
    """A copy of every counter: ``{counter: {key: n}}``."""
    with _COUNTERS_LOCK:
        return {name: dict(per) for name, per in _COUNTERS.items()}


def reset_counters() -> None:
    with _COUNTERS_LOCK:
        _COUNTERS.clear()


def _counted_since(before: dict) -> dict:
    out = {}
    for name, per in counters().items():
        got = {k: n - before.get(name, {}).get(k, 0) for k, n in per.items()}
        got = {k: n for k, n in got.items() if n}
        if got:
            out[name] = got
    return out


@contextmanager
def trace(log_dir: str):
    """Record a profile of the block into ``log_dir`` as a Chrome trace.

    The host's operations are always recorded, with their input shapes and
    the args of the package's spans; the CUDA device's kernels and copies
    too when ``rcParams["device.device"]`` is ``"cuda"``.  The file is
    ``log_dir/trace_<pid>_<n>.json``, and beside it
    ``counters_<pid>_<n>.json`` holds what the block added to the package's
    counters (:func:`counters`).  The block's end waits for the device's
    queued work, so its kernels are in the trace.  A block that raises
    still writes both files, and the exception goes on.

    >>> with trace("/tmp/loo-trace"):
    ...     loo(idata)
    """
    from torch.profiler import ProfilerActivity, profile

    from ._common import compute_device

    cuda = compute_device().type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, record_shapes=True)
    before = counters()
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
        with open(os.path.join(log_dir, f"counters_{os.getpid()}_{n}.json"), "w") as fh:
            json.dump(_counted_since(before), fh, indent=1, sort_keys=True)


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
