"""Chunk geometry, chunk indices, and each chunk of a generator or a disk source.

Counterpart of ``_resolve_chunk``, the index clamp of ``_gen_program``,
``_source_program`` and ``_gather_cols`` in ``pyloo_tpu/streaming.py``.  The
JAX package traced the generator once and hoisted its captured arrays into a
cached program; torch runs the generator eagerly, once per chunk, so nothing
is cached here.

A disk chunk source (:class:`pyloo_tpu_torch.io.NpyLogLik`) is read on the
host into one of two staging buffers, pinned when the device is CUDA, and
copied to the device with ``non_blocking=True``: the reader fills one buffer
while the other's copy is in flight, and a CUDA event recorded after each
copy gates the reuse of its buffer.  The cast to the computation dtype
happens on the device after the copy, so a float32 file computed in float64
moves 4 bytes an element.  ``pyloo_tpu`` made one blocking ``device_put``
a chunk.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_chunk", "chunk_indices", "generate", "gather_cols", "is_chunk_source",
           "chunk_maker", "SourceChunks"]

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


def is_chunk_source(obj) -> bool:
    """Disk-backed chunk sources (:class:`pyloo_tpu_torch.io.NpyLogLik` and the like)."""
    return not callable(obj) and hasattr(obj, "read_rows")


class SourceChunks:
    """Chunks of a disk source on the device, through two staging buffers.

    ``chunks(c)`` is rows ``c * chunk_size ...`` of the source as a
    ``(chunk_size, n_draws)`` tensor of ``dtype`` on ``device``; rows past
    the end of the file repeat its last row.  On CUDA the returned tensor's
    copy may still be in flight: it is ordered before any later work on the
    current stream, and the host waits for it only when it reuses the
    buffer, two chunks later.
    """

    def __init__(self, src, chunk_size: int, n_obs: int, n_draws: int, dtype: torch.dtype,
                 device: torch.device, name: str):
        if n_obs > src.n_obs:
            raise ValueError(
                f"n_obs ({n_obs}) exceeds the {src.n_obs} rows in the chunk source"
            )
        if src.n_draws != n_draws:
            raise ValueError(
                f"{name} holds {src.n_draws} draws per row, but n_draws is {n_draws}"
            )
        self._src = src
        self._chunk_size = chunk_size
        self._dtype = dtype
        self._device = device
        pinned = device.type == "cuda"  # pinned memory needs CUDA
        self._staging = [
            torch.empty((chunk_size, n_draws), dtype=src.torch_dtype, pin_memory=pinned)
            for _ in range(2)
        ]
        self._copied = [None, None]  # the event recorded after each buffer's last copy
        self._turn = 0

    def __call__(self, c: int) -> torch.Tensor:
        turn = self._turn
        self._turn ^= 1
        staging = self._staging[turn]
        if self._copied[turn] is not None:
            self._copied[turn].synchronize()  # its copy to the device has finished
        self._src._read_into(c * self._chunk_size, staging)
        if self._device.type != "cuda":
            return staging.to(self._dtype, copy=True)
        chunk = staging.to(self._device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        self._copied[turn] = copied
        return chunk.to(self._dtype)


def chunk_maker(fn, chunk_size: int, n_obs: int, n_draws: int, dtype: torch.dtype,
                device: torch.device, name: str):
    """``make(c, idx)``: chunk ``c`` of ``fn``, a generator called on the
    chunk's indices ``idx`` or a disk chunk source read at row
    ``c * chunk_size``, as a ``(chunk_size, n_draws)`` tensor of ``dtype``
    on ``device``."""
    if is_chunk_source(fn):
        chunks = SourceChunks(fn, chunk_size, n_obs, n_draws, dtype, device, name)
        return lambda c, idx: chunks(c)
    return lambda c, idx: generate(fn, idx, (chunk_size, n_draws), dtype, name)
