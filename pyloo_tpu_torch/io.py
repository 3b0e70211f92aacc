"""Log-likelihood matrices on disk, read chunk by chunk into the streaming estimators.

Counterpart of ``pyloo_tpu/io.py``.  A :class:`NpyLogLik` chunk source reads
an ``(n_obs, n_draws)`` ``.npy`` matrix that already exists on disk (another
sampler's output, a database dump, an earlier run) a chunk of rows at a
time, and every ``*_streaming`` estimator takes it in place of the
``log_lik_fn`` generator, so neither the host nor the device ever holds the
whole matrix.

Two host readers with the same semantics:

- the **native prefetcher** (``csrc/chunk_reader.cpp``, built at first use by
  :mod:`pyloo_tpu_torch._native`): a C++ thread ``pread()``s the next chunks
  into a page-aligned ring while the current one is copied and scored;
- an **np.memmap reader**, taken when no C++ compiler is available.

The streaming loop reads each chunk straight into one of two staging
buffers (pinned host memory when the device is CUDA) and copies it to the
device with ``non_blocking=True`` while the reader fills the other one
(:mod:`pyloo_tpu_torch.streaming._chunks`).

Files must be C-order ``.npy`` with shape ``(n_obs, n_draws)`` or
``(n_obs, n_chains, n_draws)``; the chain axis is flattened into draws, as
the in-memory path stacks ``__sample__``.  To write a file larger than host
memory, use ``np.lib.format.open_memmap(path, mode="w+", shape=..., dtype=...)``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ._native import load_library

__all__ = ["NpyLogLik", "loo_from_file", "waic_from_file"]


def _npy_metadata(path: str):
    """(shape, dtype, data_offset) of a C-order .npy file, validated."""
    mm = np.lib.format.open_memmap(path, mode="r")
    try:
        shape, dtype, offset = mm.shape, mm.dtype, mm.offset
        if dtype.kind != "f" or dtype.itemsize not in (4, 8):
            raise ValueError(f"log-likelihood file must be float32/float64, got {dtype}")
        if dtype.byteorder not in ("=", "<", "|") or not np.little_endian:
            raise ValueError(f"log-likelihood file must be little-endian native, got {dtype}")
        if len(shape) not in (2, 3):
            raise ValueError(
                "log-likelihood file must be (n_obs, n_draws) or"
                f" (n_obs, n_chains, n_draws), got shape {shape}"
            )
        if not mm.flags["C_CONTIGUOUS"]:
            raise ValueError("log-likelihood file must be C-order (fortran_order=False)")
        if any(s < 1 for s in shape):
            raise ValueError(f"log-likelihood file has empty axis: {shape}")
    finally:
        del mm  # release the mapping before the readers open their own
    return shape, np.dtype(dtype.str.lstrip("=<|")), offset


class _NativeReader:
    """ctypes wrapper over the C++ ring prefetcher."""

    def __init__(self, lib, path, offset, row_bytes, n_rows, chunk_rows, depth):
        self._lib = lib
        self._handle = lib.cr_open(os.fsencode(path), offset, row_bytes, n_rows, chunk_rows, depth)
        if not self._handle:
            raise OSError(f"native chunk reader failed to open {path!r}")
        self.chunk_rows = chunk_rows

    def read(self, chunk_index: int, out: np.ndarray) -> int:
        """Chunk ``chunk_index`` copied into ``out``'s memory (its data pointer
        goes to ``cr_read``); returns the rows read."""
        rows = self._lib.cr_read(self._handle, chunk_index, out.ctypes.data)
        if rows < 0:
            raise OSError(f"I/O error reading chunk {chunk_index} from the log-likelihood file")
        return int(rows)

    @property
    def reads_issued(self) -> int:
        """Chunk preads started since open (a sequential full pass issues
        exactly n_chunks; more means the pipeline reset and read again)."""
        return int(self._lib.cr_reads_issued(self._handle)) if self._handle else 0

    def close(self):
        if self._handle:
            self._lib.cr_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - belt and braces
        try:
            self.close()
        except Exception:
            pass


class _MemmapReader:
    """Same interface as :class:`_NativeReader`, through ``np.memmap``."""

    def __init__(self, path, offset, dtype, n_rows, row_elems, chunk_rows):
        self._mm = np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=(n_rows, row_elems))
        self.chunk_rows = chunk_rows
        self._n_rows = n_rows

    def read(self, chunk_index: int, out: np.ndarray) -> int:
        start = chunk_index * self.chunk_rows
        if start >= self._n_rows:
            return 0
        stop = min(start + self.chunk_rows, self._n_rows)
        rows = stop - start
        out.reshape(self.chunk_rows, -1)[:rows] = self._mm[start:stop]
        return rows

    def close(self):
        self._mm = None


class NpyLogLik:
    """Chunk source over an ``(n_obs, n_draws)`` ``.npy`` matrix on disk.

    Pass it to :func:`pyloo_tpu_torch.loo_streaming` (or any ``*_streaming``
    estimator) in place of ``log_lik_fn``: chunks are read from disk,
    prefetched by the native reader when it is available, and copied to the
    device one at a time.  :func:`loo_from_file` and :func:`waic_from_file`
    wrap the common cases.

    Parameters
    ----------
    path : str
        C-order ``.npy`` file, shape ``(n_obs, n_draws)`` or
        ``(n_obs, n_chains, n_draws)`` (chains flatten into draws), dtype
        float32 or float64.
    depth : int
        Ring slots of the native prefetcher (chunks read ahead). Default 4.
    native : bool, optional
        Force (``True``) or forbid (``False``) the native reader; by default
        it is used when it builds, and ``np.memmap`` otherwise.
    """

    def __init__(self, path: str, *, depth: int = 4, native: bool | None = None):
        shape, dtype, offset = _npy_metadata(path)
        self.path = path
        self.n_obs = int(shape[0])
        self.n_draws = int(np.prod(shape[1:]))
        self.dtype = dtype
        self._offset = offset
        self._depth = int(depth)
        if self._depth < 1:
            raise ValueError("depth must be >= 1")
        lib = load_library() if native in (None, True) else None
        if native is True and lib is None:
            raise RuntimeError(
                "native=True but the chunk-reader library is unavailable"
                " (no C++ compiler, or PYLOO_TPU_NO_NATIVE is set)"
            )
        self._lib = lib
        self._reader = None
        self.is_native = lib is not None

    @property
    def torch_dtype(self) -> torch.dtype:
        """The file's dtype as a torch dtype (that of the staging buffers)."""
        return getattr(torch, self.dtype.name)

    def _ensure_reader(self, chunk_rows: int):
        if self._reader is not None and self._reader.chunk_rows == chunk_rows:
            return self._reader
        if self._reader is not None:
            self._reader.close()
        if self._lib is not None:
            self._reader = _NativeReader(
                self._lib, self.path, self._offset, self.n_draws * self.dtype.itemsize,
                self.n_obs, chunk_rows, self._depth,
            )
        else:
            self._reader = _MemmapReader(
                self.path, self._offset, self.dtype, self.n_obs, self.n_draws, chunk_rows
            )
        return self._reader

    def _fill(self, start_row: int, out: np.ndarray) -> None:
        """Rows ``start_row...`` into ``out`` (``(n_rows, n_draws)``, the file's
        dtype), rows past the end of the file repeating the last file row."""
        n_rows = out.shape[0]
        if n_rows < 1:
            raise ValueError("n_rows must be positive")
        if start_row % n_rows:
            raise ValueError(
                f"start_row ({start_row}) must be a multiple of the chunk size ({n_rows})"
            )
        got = self._ensure_reader(n_rows).read(start_row // n_rows, out)
        if got == 0:
            raise ValueError(
                f"chunk starting at row {start_row} is past the end of the file"
                f" ({self.n_obs} rows)"
            )
        if got < n_rows:
            out[got:] = out[got - 1]

    def read_rows(self, start_row: int, n_rows: int) -> np.ndarray:
        """``(n_rows, n_draws)`` chunk starting at ``start_row``.

        ``start_row`` must be a multiple of ``n_rows`` (the streaming loops'
        access pattern); rows past the end of the file repeat the last file
        row, the padding a generator gives by clamping its indices, which
        every streaming accumulator masks out.
        """
        if n_rows < 1:
            raise ValueError("n_rows must be positive")
        out = np.empty((n_rows, self.n_draws), self.dtype)
        self._fill(start_row, out)
        return out

    def _read_into(self, start_row: int, out: torch.Tensor) -> None:
        """:meth:`read_rows` into a caller's host tensor (pinned or not): the
        reader writes the rows into ``out``'s memory, with no array of its
        own per chunk and no copy after."""
        if (out.device.type != "cpu" or out.dtype != self.torch_dtype
                or out.dim() != 2 or out.shape[1] != self.n_draws or not out.is_contiguous()):
            raise ValueError(
                f"out must be a contiguous ({out.shape[0]}, {self.n_draws}) {self.torch_dtype}"
                f" tensor on the host, got {tuple(out.shape)} {out.dtype} on {out.device}"
            )
        self._fill(start_row, out.numpy())

    @property
    def reads_issued(self) -> int | None:
        """Chunk preads issued by the native reader (``None`` for the memmap
        reader or before the first read)."""
        if isinstance(self._reader, _NativeReader):
            return self._reader.reads_issued
        return None

    def gather_rows(self, idx) -> np.ndarray:
        """``(len(idx), n_draws)`` rows at arbitrary observation indices.

        Random access for the subsampling estimators, which score a few
        sampled rows exactly; served by a short-lived memmap, since prefetch
        buys nothing for scattered reads.
        """
        idx = np.asarray(idx)
        if idx.ndim != 1 or (idx.size and (idx.min() < 0 or idx.max() >= self.n_obs)):
            raise ValueError(f"indices must be 1-D within [0, {self.n_obs})")
        mm = np.memmap(
            self.path, dtype=self.dtype, mode="r", offset=self._offset,
            shape=(self.n_obs, self.n_draws),
        )
        try:
            return np.array(mm[idx])
        finally:
            del mm

    def close(self):
        if self._reader is not None:
            self._reader.close()
            self._reader = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def loo_from_file(path: str, *, depth: int = 4, native: bool | None = None, **kwargs):
    """PSIS-LOO over a ``.npy`` log-likelihood matrix on disk.

    The same ELPDData and warnings as ``loo_streaming`` over a generator of
    the same rows, with host and device memory O(chunk): the file is
    streamed through :func:`pyloo_tpu_torch.loo_streaming`, whose keyword
    arguments (``reff``, ``pointwise``, ``method``, ``chunk_size``,
    ``dtype``, ``mesh``, ``checkpoint_path``, ...) pass through; over a
    ``mesh`` each chunk's shards are copied from the staging buffer to
    their devices.

    The file's chain structure is flattened, so ``reff`` defaults to 1.0:
    pass the relative efficiency from your sampler to match ``loo()`` on
    multi-chain posteriors.
    """
    from .streaming import loo_streaming

    with NpyLogLik(path, depth=depth, native=native) as src:
        return loo_streaming(src, src.n_obs, src.n_draws, **kwargs)


def waic_from_file(path: str, *, depth: int = 4, native: bool | None = None, **kwargs):
    """WAIC over a ``.npy`` log-likelihood matrix on disk (streamed)."""
    from .streaming import waic_streaming

    with NpyLogLik(path, depth=depth, native=native) as src:
        return waic_streaming(src, src.n_obs, src.n_draws, **kwargs)
