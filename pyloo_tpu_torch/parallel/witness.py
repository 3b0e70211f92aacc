"""Machine-checked scaling witnesses of a sharded LOO call: a transfer census
and per-device work.

Counterpart of ``pyloo_tpu/parallel/witness.py``.  The design claims
(SURVEY.md §5) that every per-observation kernel is parallel over rows, so
the only traffic of a sharded LOO call between devices is the final scalar
reductions, and the work per device stays constant when the rows per device
do.  ``pyloo_tpu`` reads both from the compiled, SPMD-partitioned program: its
collectives (:func:`collective_census`) and XLA's per-device FLOP count.  In
this package one process drives the cards with eager torch, so the same two
properties are read from what torch records of a run:

* :func:`transfer_census` runs a function under ``torch.profiler`` with CUDA
  activity and sorts every memory copy the cards made by kind, with its
  bytes: ``"peer"`` (between two cards), ``"device_to_device"`` (within one
  card), ``"device_to_host"`` and ``"host_to_device"``.
  :func:`assert_scalar_only_transfers` fails on any copy between two cards
  larger than a handful of scalars.  Per-row outputs may go to the host: the
  results of this package live there.
* :func:`launch_census` counts the launches of kernels A and B on each
  device during a call, from the wrappers' per-device counts
  (``ops.topk.loo_prepass.by_device``, ``ops.topk.topk_desc.by_device``);
  :func:`assert_flat_weak_scaling` holds them equal across mesh sizes run
  at the same rows per device.

``compiled_flops`` has no counterpart: an eager call compiles no program
whose cost could be read before it runs, and torch has no FLOP count of the
hand-written kernels.  The launches per device, each over the same rows,
stand in for it.
"""

from __future__ import annotations

import json
import os
import tempfile

__all__ = [
    "census_of",
    "transfer_census",
    "assert_scalar_only_transfers",
    "launch_census",
    "assert_flat_weak_scaling",
]

# "a handful of scalars": eight float64 values
SCALAR_BYTES = 64

_KINDS = {"PtoP": "peer", "DtoD": "device_to_device", "DtoH": "device_to_host",
          "HtoD": "host_to_device"}


def _endpoints(args: dict):
    """The (source, destination) devices a copy's record names, when it does."""
    src = next((args[k] for k in ("src device", "srcDevice", "src_device") if k in args), None)
    dst = next((args[k] for k in ("dst device", "dstDevice", "dst_device") if k in args), None)
    return src, dst


def census_of(events) -> dict:
    """Map copy kind -> list of byte counts, from Chrome-trace events (dicts
    with ``name`` and ``args``, as ``torch.profiler`` exports them).

    A record named ``Memcpy PtoP`` is a copy between two cards; a
    ``Memcpy DtoD`` whose record names two different devices is one too.
    Records that are not copies are skipped.
    """
    census = {kind: [] for kind in _KINDS.values()}
    for event in events:
        name = event.get("name", "")
        if not name.startswith("Memcpy"):
            continue
        args = event.get("args", {}) or {}
        kind = next((k for tag, k in _KINDS.items() if tag in name), None)
        if kind is None:
            continue
        src, dst = _endpoints(args)
        if kind == "device_to_device" and src is not None and dst is not None and src != dst:
            kind = "peer"
        census[kind].append(int(args.get("bytes", 0)))
    return census


def transfer_census(fn):
    """``(fn(), census)``: ``fn`` run under ``torch.profiler`` with CUDA
    activity, the device's queued work waited for, and :func:`census_of` the
    trace it recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        for index in range(torch.cuda.device_count()):
            torch.cuda.synchronize(index)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    return out, census_of(events)


def assert_scalar_only_transfers(census: dict, *, max_bytes: int = SCALAR_BYTES) -> dict:
    """Assert that no copy between two cards moved more than ``max_bytes``;
    return the census.  A larger one means the call exchanged more than its
    final scalars between devices, against the observation-sharding design."""
    bad = [n for n in census.get("peer", []) if n > max_bytes]
    if bad:
        raise AssertionError(
            f"{len(bad)} copies between cards larger than {max_bytes} bytes"
            f" (largest {max(bad)} bytes); a sharded LOO call may only move its"
            " final scalars between devices"
        )
    return census


def _per_device_launches() -> dict:
    from ..ops import topk

    counts = dict(topk.loo_prepass.by_device)
    for by_device in topk.topk_desc.by_device.values():
        for device, n in by_device.items():
            counts[device] = counts.get(device, 0) + n
    return counts


def launch_census(fn):
    """``(fn(), launches)``: ``launches`` maps each CUDA device to the kernel
    A and B launches made on it during ``fn`` (no counter is reset)."""
    before = _per_device_launches()
    out = fn()
    after = _per_device_launches()
    launches = {d: n - before.get(d, 0) for d, n in after.items() if n - before.get(d, 0)}
    return out, launches


def assert_flat_weak_scaling(runs: dict) -> dict:
    """``runs`` maps a mesh size to the launches per shard of a run at the
    same rows per shard (``{size: [launches of shard 0, ...]}``).  Asserts
    that every shard of every run launched alike: the work per device is
    flat as the mesh grows.  Returns ``runs``."""
    seen = {n for per_shard in runs.values() for n in per_shard}
    if len(seen) != 1 or any(len(v) != size for size, v in runs.items()):
        raise AssertionError(
            f"launches per shard differ across mesh sizes at constant rows per shard: {runs}"
        )
    return runs
