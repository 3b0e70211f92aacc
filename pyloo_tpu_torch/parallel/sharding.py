"""Chunked row-parallel execution on one device.

Counterpart of ``apply_rowwise`` in ``pyloo_tpu/parallel/sharding.py``.  The
JAX package's observation mesh and its collective census are specific to
JAX's sharding and are not ported: this package runs on one device.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["apply_rowwise"]

# Device-memory budget of one scorer call, input AND temporaries.  A scorer
# holds up to about _LIVE_ROW_BUFFERS full-width (chunk, S) buffers at once
# (the block, its negation, the shifted rows and an exp/mask temporary of the
# plain reductions), so the chunk gets 1/_LIVE_ROW_BUFFERS of the budget:
# 131,072 rows x 4,000 draws in float32 (2 GiB a buffer), 65,536 in float64.
# A function that holds more (a full-width output, an argsort's indices)
# says how many more with ``extra_buffers``.
_DEFAULT_CHUNK_BYTES = 8 << 30
_LIVE_ROW_BUFFERS = 4


def chunk_rows(
    s: int, itemsize: int, chunk_bytes: int = _DEFAULT_CHUNK_BYTES, extra_buffers: int = 0
) -> int:
    """Rows per scorer call: a power of two within the byte budget (at least 1)."""
    live = _LIVE_ROW_BUFFERS + extra_buffers
    rows = max(1, chunk_bytes // (live * max(s, 1) * itemsize))
    return 1 << (rows.bit_length() - 1)


def apply_rowwise(
    kernel: Callable,
    rows,
    *,
    chunk_bytes: int = _DEFAULT_CHUNK_BYTES,
    extra_buffers: int = 0,
):
    """Run a row-parallel function over (B, S) tensors in byte-budgeted chunks.

    ``rows`` is one ``(B, S)`` tensor or a tuple of tensors with the same
    leading dimension (the first sets S and the item size); ``kernel`` takes
    one ``(chunk, ...)`` block of each and returns a tuple of outputs whose
    leading dimension is the chunk size.  Chunks are views of the inputs, so
    only the function's temporaries are allocated per chunk.

    With more than one chunk each output is written into one tensor
    allocated for all B rows: an output as wide as the input, such as a
    weight matrix, is never held as pieces and as their concatenation at
    once.  ``extra_buffers`` counts the full-width ``(chunk, S)`` buffers the
    function holds beyond the scorers' ``_LIVE_ROW_BUFFERS``, a wide output
    among them.
    """
    inputs = tuple(rows) if isinstance(rows, (tuple, list)) else (rows,)
    B, S = inputs[0].shape
    chunk = chunk_rows(S, inputs[0].element_size(), chunk_bytes, extra_buffers)
    if chunk >= B:
        return tuple(kernel(*inputs))
    outs = None
    for start in range(0, B, chunk):
        piece = kernel(*(t[start : start + chunk] for t in inputs))
        if outs is None:
            outs = tuple(p.new_empty((B,) + p.shape[1:]) for p in piece)
        for out, p in zip(outs, piece):
            out[start : start + chunk] = p
        del piece
    return outs
