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
_DEFAULT_CHUNK_BYTES = 8 << 30
_LIVE_ROW_BUFFERS = 4


def chunk_rows(s: int, itemsize: int, chunk_bytes: int = _DEFAULT_CHUNK_BYTES) -> int:
    """Rows per scorer call: a power of two within the byte budget (at least 1)."""
    rows = max(1, chunk_bytes // (_LIVE_ROW_BUFFERS * max(s, 1) * itemsize))
    return 1 << (rows.bit_length() - 1)


def apply_rowwise(
    kernel: Callable,
    rows: torch.Tensor,
    *,
    chunk_bytes: int = _DEFAULT_CHUNK_BYTES,
):
    """Run a row-parallel scorer over a (B, S) tensor in byte-budgeted chunks.

    ``kernel`` maps a ``(chunk, S)`` block to a tuple of per-row outputs whose
    leading dimension is the chunk size; the outputs are concatenated on the
    block's device.  Chunks are views of ``rows``, so only the scorer's
    temporaries are allocated per chunk.
    """
    B, S = rows.shape
    chunk = chunk_rows(S, rows.element_size(), chunk_bytes)
    pieces = [kernel(rows[start : start + chunk]) for start in range(0, B, chunk)]
    if len(pieces) == 1:
        return tuple(pieces[0])
    return tuple(torch.cat(outs, dim=0) for outs in zip(*pieces))
