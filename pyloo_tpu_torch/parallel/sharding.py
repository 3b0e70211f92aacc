"""Row-parallel execution over the devices of an observation mesh.

Counterpart of ``pyloo_tpu/parallel/sharding.py``.  Every per-observation
scorer is parallel over rows, so the layout is the JAX package's: a 1-D
mesh of devices, each holding one block of rows (SURVEY.md §5).  Here a mesh
is an ordered tuple of ``torch.device``, one shard each, driven by one
process: no ``torch.distributed``, no collective.  Each device scores its own
rows; only per-row outputs and scalars come back.  The draws of
``loo_nonfactor`` and the lanes of batched moment matching are sharded the
same way by their modules.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

from ..ops.guard import run_decided

__all__ = ["Mesh", "obs_mesh", "default_mesh", "as_mesh", "device_scope", "shard_bounds",
           "guard_groups", "apply_rowwise"]

# Device-memory budget of one scorer call, input AND temporaries.  A scorer
# holds up to about _LIVE_ROW_BUFFERS full-width (chunk, S) buffers at once
# (the block, its negation, the shifted rows and an exp/mask temporary of the
# plain reductions), so the chunk gets 1/_LIVE_ROW_BUFFERS of the budget:
# 131,072 rows x 4,000 draws in float32 (2 GiB a buffer), 65,536 in float64.
# A function that holds more (a full-width output, an argsort's indices)
# says how many more with ``extra_buffers``.  The budget is per device.
_DEFAULT_CHUNK_BYTES = 8 << 30
_LIVE_ROW_BUFFERS = 4

# pyloo_tpu's byte budget of one chunk of rows with no mesh (its
# _DEFAULT_CHUNK_BYTES): its chunks are the float64 deep-tail guard's batches
_GUARD_CHUNK_BYTES = 2 << 30


class Mesh:
    """A 1-D ``("obs",)`` mesh: an ordered tuple of devices, one shard each.

    ``devices`` may repeat a device: each entry is a shard of its own, so a
    mesh of ``("cuda:0",) * 4`` runs the split, the launches of every shard
    and the merge on one card.  A mesh is a context manager, as JAX's is
    (``with obs_mesh() as mesh:``); entering it changes nothing.
    """

    axis_names = ("obs",)

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self.devices)})"


def _visible_devices() -> list:
    """The CUDA devices this process sees, in index order."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def obs_mesh(devices: Sequence | None = None) -> Mesh | None:
    """A mesh over ``devices`` (default: every visible CUDA device); None
    when that is a single device or none."""
    devices = list(devices) if devices is not None else _visible_devices()
    if len(devices) <= 1:
        return None
    return Mesh(devices)


def default_mesh(device: torch.device) -> Mesh | None:
    """:func:`obs_mesh` when its devices are of ``device``'s kind, else None:
    work placed on the CPU is not moved to the cards of the default mesh."""
    mesh = obs_mesh()
    if mesh is not None and mesh.devices[0].type != torch.device(device).type:
        return None
    return mesh


def as_mesh(mesh, name: str) -> Mesh | None:
    """``mesh`` itself when it is a :class:`Mesh` or None; raises otherwise."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"{name}: mesh must be a pyloo_tpu_torch.parallel.Mesh (see obs_mesh) or None,"
            f" got {type(mesh).__name__}"
        )
    return mesh


def device_scope(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, else a no-op."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# Rows a shard of apply_rowwise starts at a multiple of.  The CPU's
# elementwise kernels take their elements in vector blocks (up to 32 floats)
# and the ragged end of a tensor one by one, and the two give a
# transcendental function's last bit differently; a shard that starts at a
# multiple of 64 rows holds each row at the place in a block it has in the
# whole batch, so its results are the batch's bit for bit.
_SHARD_ALIGN = 64


def shard_bounds(n: int, shards: int) -> list:
    """``(start, stop)`` of each shard's rows: ``n`` padded to a multiple of
    ``shards`` and cut in equal blocks, a block's rows rounded up to a
    multiple of ``_SHARD_ALIGN``, the padding dropped (so the last shards
    may be short, or empty)."""
    per = -(-max(n, shards) // shards)
    per = -(-per // _SHARD_ALIGN) * _SHARD_ALIGN
    return [(min(j * per, n), min((j + 1) * per, n)) for j in range(shards)]


def chunk_rows(
    s: int, itemsize: int, chunk_bytes: int = _DEFAULT_CHUNK_BYTES, extra_buffers: int = 0
) -> int:
    """Rows per scorer call: a power of two within the byte budget (at least 1)."""
    live = _LIVE_ROW_BUFFERS + extra_buffers
    rows = max(1, chunk_bytes // (live * max(s, 1) * itemsize))
    return 1 << (rows.bit_length() - 1)


def guard_groups(b: int, s: int, itemsize: int, mesh: Mesh | None) -> list:
    """``pyloo_tpu``'s decision groups of the float64 deep-tail guard over
    ``b`` rows of ``apply_rowwise``, as ``(start, stop)`` ranges.

    Over a mesh ``pyloo_tpu`` makes one sharded call, and GSPMD turns the
    guard's ``jnp.all`` into a reduction across the mesh: one group, the
    whole call (its zero padding rows switch nothing).  With no mesh it
    runs chunks of ``_GUARD_CHUNK_BYTES // (S * itemsize)`` rows, each a
    call of its own (``pyloo_tpu/parallel/sharding.py:73-101``).  The port's
    own chunks and shards do not change the groups.
    """
    if mesh is not None:
        return [(0, b)]
    chunk = max(1, _GUARD_CHUNK_BYTES // max(s * itemsize, 1))
    return [(a, min(a + chunk, b)) for a in range(0, b, chunk)]


def apply_rowwise(
    kernel: Callable,
    rows,
    *,
    mesh: Mesh | None = None,
    chunk_bytes: int = _DEFAULT_CHUNK_BYTES,
    extra_buffers: int = 0,
    decide_over: str = "chunks",
):
    """Run a row-parallel function over (B, S) tensors, on every device of a
    mesh, in byte-budgeted chunks on each.

    ``rows`` is one ``(B, S)`` tensor or a tuple of tensors with the same
    leading dimension (the first sets S and the item size); ``kernel`` takes
    one ``(chunk, ...)`` block of each and returns a tuple of outputs whose
    leading dimension is the chunk size.  Chunks are views of the inputs, so
    only the function's temporaries are allocated per chunk.  With more than
    one chunk each output is written into one tensor allocated for all
    rows: an output as wide as the input, such as a weight matrix, is never
    held as pieces and as their concatenation at once.  ``extra_buffers``
    counts the full-width ``(chunk, S)`` buffers the function holds beyond
    the scorers' ``_LIVE_ROW_BUFFERS``, a wide output among them.

    ``mesh`` None takes :func:`obs_mesh`, as ``pyloo_tpu`` does, when the
    inputs lie on the kind of device it spans.  Over a mesh, B is padded to a
    multiple of its size and each device gets its block of rows
    (:func:`shard_bounds`; the padding is never computed: the last blocks
    are short), each chunk copied there and run under its device's context;
    every device is queued before anything is read back.  The outputs are
    gathered in row order on the inputs' device.

    The float64 fits inside ``kernel`` decide the deep-tail branch over
    ``pyloo_tpu``'s batches (:mod:`pyloo_tpu_torch.ops.guard`):
    :func:`guard_groups` for ``decide_over="chunks"``, the whole call for
    ``"call"`` (a function ``pyloo_tpu`` runs as one program over all
    rows).  With no deep-tail row a float64 call reads the host once, after
    every chunk of every device is queued; a row's outputs are then the
    same computation with or without a mesh, on another device.
    """
    inputs = tuple(rows) if isinstance(rows, (tuple, list)) else (rows,)
    if mesh is None:
        mesh = default_mesh(inputs[0].device)
    B, S = inputs[0].shape[:2]
    if B == 0:
        return tuple(kernel(*inputs))
    home = inputs[0].device
    itemsize = inputs[0].element_size()
    chunk = chunk_rows(S, itemsize, chunk_bytes, extra_buffers)
    if mesh is None:
        shards = [(home, 0, B)]
    else:
        shards = [(d, start, stop) for d, (start, stop) in
                  zip(mesh.devices, shard_bounds(B, mesh.size)) if start < stop]
    groups = [(0, B)] if decide_over == "call" else guard_groups(B, S, itemsize, mesh)

    def pieces():
        for device, first, last in shards:
            for start in range(first, last, chunk):
                stop = min(start + chunk, last)

                def run(device=device, start=start, stop=stop):
                    with device_scope(device):
                        block = (t[start:stop].to(device, non_blocking=True) for t in inputs)
                        return tuple(kernel(*block))

                yield start, stop, run

    outs = []

    def sink(start, stop, got):
        if start == 0 and stop == B and got[0].device == home:
            outs[:] = got  # one piece: its outputs as they are
            return
        if not outs:
            outs.extend(p.new_empty((B,) + p.shape[1:], device=home) for p in got)
        for out, p in zip(outs, got):
            out[start:stop] = p

    run_decided(pieces(), groups, sink)
    return tuple(outs)
