"""Chunk geometry, chunk indices and the per-chunk call of the user's generator.

Counterpart of ``_resolve_chunk``, the index clamp of ``_gen_program`` and
``_gather_cols`` in ``pyloo_tpu/streaming.py``.  The JAX package traced the
generator once and hoisted its captured arrays into a cached program; torch
runs the generator eagerly, once per chunk, so nothing is cached here.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_chunk", "chunk_indices", "generate", "gather_cols"]

# Log-likelihood bytes of one chunk: ~2 GB, as in pyloo_tpu.
CHUNK_BUDGET = 2 << 30
_MULTIPLE = 8


def resolve_chunk(chunk_size, n_obs: int, n_draws: int, dtype: torch.dtype,
                  budget: int = CHUNK_BUDGET):
    """Final chunk geometry: ``(chunk_size, n_chunks)``.

    With no ``chunk_size``: the fewest chunks whose ``(chunk, n_draws)``
    payload stays within ``budget`` bytes, the sweep split evenly across
    them and rounded up to a multiple of 8, so padding is under 8 rows in
    all.  An explicit ``chunk_size`` is clamped to ``n_obs`` and rounded
    down to a multiple of 8 (at least 8), the geometry checkpoints record.
    """
    if chunk_size is None:
        cap = max(budget // (n_draws * dtype.itemsize), _MULTIPLE)
        cap = int(min(cap, n_obs))
        n_chunks = -(-n_obs // cap)
        chunk_size = -(-n_obs // n_chunks)
        chunk_size = -(-chunk_size // _MULTIPLE) * _MULTIPLE
    else:
        chunk_size = int(min(chunk_size, n_obs))
        chunk_size = max(_MULTIPLE, chunk_size - chunk_size % _MULTIPLE)
    return chunk_size, -(-n_obs // chunk_size)


def chunk_indices(c: int, chunk_size: int, n_obs: int, device: torch.device):
    """``(idx, valid)`` of chunk ``c``: int64 observation indices clamped to
    ``n_obs - 1`` (a ragged last chunk repeats the last observation), and
    the mask of the rows that are real."""
    raw = torch.arange(c * chunk_size, (c + 1) * chunk_size, device=device)
    return raw.clamp_max(n_obs - 1), raw < n_obs


def generate(fn, idx: torch.Tensor, shape: tuple, dtype: torch.dtype, name: str):
    """``fn(idx)`` checked and cast to the computation dtype.

    The result must be a tensor of ``shape`` on ``idx``'s device: a tensor
    made elsewhere raises rather than being moved, since a host-made chunk
    copied to the card is the cost streaming exists to avoid.
    """
    out = fn(idx)
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"{name} must return a torch.Tensor, got {type(out).__name__}")
    if out.device.type != idx.device.type:
        raise ValueError(
            f"{name} returned a tensor on {out.device}, but the computation runs on"
            f" {idx.device} (rcParams['device.device']); make the chunk there"
        )
    if tuple(out.shape) != shape:
        raise ValueError(f"{name} returned shape {tuple(out.shape)}, expected {shape}")
    return out.to(dtype)


def gather_cols(ll: torch.Tensor, col_idx: torch.Tensor) -> torch.Tensor:
    """Draw reindex of a generated chunk (importance-resampled columns)."""
    return ll.index_select(1, col_idx)
