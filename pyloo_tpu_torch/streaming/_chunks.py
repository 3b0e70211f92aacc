"""Chunk geometry, chunk indices, shards, and each shard of a generator or a disk source.

Counterpart of ``_resolve_chunk``, the index clamp of ``_gen_program``,
``_source_program`` and ``_gather_cols`` in ``pyloo_tpu/streaming.py``.  The
JAX package traced the generator once and hoisted its captured arrays into a
cached program; torch runs the generator eagerly, once per chunk and shard,
so nothing is cached here.

Over a mesh (:class:`pyloo_tpu_torch.parallel.Mesh`) each chunk's rows are
dealt in equal blocks over its devices (:class:`Shards`), as ``pyloo_tpu``
shards a chunk with ``P("obs", None)``; the generator is called once per
shard with the shard's indices on the shard's device.

A disk chunk source (:class:`pyloo_tpu_torch.io.NpyLogLik`) is read on the
host into one of two staging buffers, pinned when the devices are CUDA, and
each shard's rows are copied to its device with ``non_blocking=True``: the
reader fills one buffer while the other's copies are in flight, and a CUDA
event recorded after each copy, one a device, gates the reuse of its buffer.
The cast to the computation dtype happens on the device after the copy, so
a float32 file computed in float64 moves 4 bytes an element.  ``pyloo_tpu``
made one blocking ``device_put`` a chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.guard import run_decided
from ..parallel.sharding import Mesh, device_scope

__all__ = ["resolve_chunk", "chunk_indices", "generate", "gather_cols", "is_chunk_source",
           "chunk_maker", "SourceChunks", "Shards"]

# Log-likelihood bytes of one chunk: ~2 GB, as in pyloo_tpu.
CHUNK_BUDGET = 2 << 30
_MULTIPLE = 8


def resolve_chunk(chunk_size, n_obs: int, n_draws: int, dtype: torch.dtype,
                  budget: int = CHUNK_BUDGET, mesh: Mesh | None = None):
    """Final chunk geometry: ``(chunk_size, n_chunks)``.

    The multiple is 8, or ``lcm(8, mesh.size)`` over a mesh, as in
    ``pyloo_tpu``.  With no ``chunk_size``: the fewest chunks whose
    ``(chunk, n_draws)`` payload stays within ``budget`` bytes, the sweep
    split evenly across them and rounded up to the multiple, so padding is
    under one multiple of rows in all.  An explicit ``chunk_size`` is
    clamped to ``n_obs`` and rounded down to the multiple (at least one),
    the geometry checkpoints record.
    """
    multiple = _MULTIPLE if mesh is None else int(np.lcm(_MULTIPLE, mesh.size))
    if chunk_size is None:
        cap = max(budget // (n_draws * dtype.itemsize), _MULTIPLE)
        cap = int(min(cap, n_obs))
        n_chunks = -(-n_obs // cap)
        chunk_size = -(-n_obs // n_chunks)
        chunk_size = -(-chunk_size // multiple) * multiple
    else:
        chunk_size = int(min(chunk_size, n_obs))
        chunk_size = max(multiple, chunk_size - chunk_size % multiple)
    return chunk_size, -(-n_obs // chunk_size)


class Shards:
    """How each chunk's rows are dealt over the devices of a mesh.

    Shard ``j`` of chunk ``c`` is rows ``c * chunk_size + j * rows`` onwards,
    ``rows = chunk_size / n_shards`` of them, on ``devices[j]``; with no mesh
    there is one shard, the whole chunk, on the computation device.  A
    per-row buffer is one tensor a shard, on its device, holding the shard's
    rows of every chunk in chunk order (:meth:`buffers`); :meth:`host`
    gathers such buffers into one host array in row order.
    """

    def __init__(self, mesh: Mesh | None, chunk_size: int, n_chunks: int, n_obs: int,
                 device: torch.device):
        self.devices = mesh.devices if mesh is not None else (device,)
        self.chunk_size, self.n_chunks, self.n_obs = chunk_size, n_chunks, n_obs
        self.rows = chunk_size // len(self.devices)
        self._copies: dict = {}

    def __iter__(self):
        return iter(enumerate(self.devices))

    def scope(self, j: int):
        """The context shard ``j``'s work is queued in: its device current."""
        return device_scope(self.devices[j])

    def indices(self, c: int, j: int):
        """``(idx, valid)`` of shard ``j`` of chunk ``c`` on its device (as
        :func:`chunk_indices`)."""
        start = c * self.chunk_size + j * self.rows
        raw = torch.arange(start, start + self.rows, device=self.devices[j])
        return raw.clamp_max(self.n_obs - 1), raw < self.n_obs

    def part(self, c: int) -> slice:
        """The rows of chunk ``c`` in a shard's buffer."""
        return slice(c * self.rows, (c + 1) * self.rows)

    def buffers(self, dtype: torch.dtype, trailing: tuple = ()) -> list:
        """One zeroed ``(n_chunks * rows, *trailing)`` buffer a shard."""
        return [torch.zeros((self.n_chunks * self.rows,) + tuple(trailing), dtype=dtype,
                            device=d) for d in self.devices]

    def split(self, host: np.ndarray, dtype: torch.dtype) -> list:
        """A host array of ``n_chunks * chunk_size`` rows as shard buffers."""
        n = len(self.devices)
        blocks = host.reshape((self.n_chunks, n, self.rows) + host.shape[1:])
        return [torch.from_numpy(np.ascontiguousarray(blocks[:, j]).reshape(
                    (self.n_chunks * self.rows,) + host.shape[1:])).to(d, dtype)
                for j, d in enumerate(self.devices)]

    def host(self, buffers: list, n_rows: int | None = None) -> np.ndarray:
        """Shard buffers as one host array in row order, its first ``n_rows``
        rows (default ``n_obs``)."""
        parts = [b.cpu().numpy() for b in buffers]
        trailing = parts[0].shape[1:]
        stacked = np.stack([p.reshape((self.n_chunks, self.rows) + trailing) for p in parts],
                           axis=1)
        flat = stacked.reshape((self.n_chunks * self.chunk_size,) + trailing)
        return flat[: self.n_obs if n_rows is None else n_rows]

    def decided(self, work) -> list:
        """Every shard's work on one chunk, its float64 fits deciding the
        deep-tail branch over the whole chunk, ``pyloo_tpu``'s batch
        (:func:`pyloo_tpu_torch.ops.guard.run_decided`).  ``work(j)``, called
        under shard ``j``'s device, queues what runs once (the generator)
        and returns a function that scores it, which may run twice; shard
        ``j + 1`` is made after shard ``j`` is queued.  Returns the scores
        in shard order."""
        got = [None] * len(self.devices)

        def pieces():
            for j, _ in self:
                with self.scope(j):
                    score = work(j)

                def run(j=j, score=score):
                    with self.scope(j):
                        return score()

                yield j * self.rows, (j + 1) * self.rows, run
                del score, run  # run_decided keeps what may run again

        def sink(start, stop, out):
            got[start // self.rows] = out

        run_decided(pieces(), [(0, self.chunk_size)], sink)
        return got

    def on(self, tensor: torch.Tensor, j: int) -> torch.Tensor:
        """A copy of ``tensor`` on shard ``j``'s device, made once a device."""
        device = self.devices[j]
        key = (id(tensor), str(device))
        if key not in self._copies:
            self._copies[key] = tensor.to(device)
        return self._copies[key]


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
    copied to the card is the cost streaming exists to avoid.  Over a mesh
    ``idx`` lies on the shard's device, so a generator that closes over
    tensors on one card must key copies of them on ``idx.device``.
    """
    try:
        out = fn(idx)
    except RuntimeError as err:
        if "device" not in str(err):
            raise
        raise RuntimeError(
            f"{name} failed on indices on {idx.device}: {err}. Over a mesh {name} is called"
            " once a shard with the shard's indices on the shard's device and must return"
            " rows on idx.device; keep a copy of each tensor it reads on every device of"
            " the mesh, keyed on idx.device"
        ) from err
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"{name} must return a torch.Tensor, got {type(out).__name__}")
    if out.device != idx.device:
        if out.device.type == idx.device.type:
            raise ValueError(
                f"{name} returned a tensor on {out.device} for indices on {idx.device}:"
                f" over a mesh {name} must return rows on idx.device"
            )
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
    """Shards of a disk source's chunks on their devices, through two
    staging buffers.

    ``chunks(c, j)`` is shard ``j`` of rows ``c * chunk_size ...`` of the
    source (the whole chunk when ``devices`` is one device) as a tensor of
    ``dtype`` on ``devices[j]``; rows past the end of the file repeat its
    last row.  The chunk is read into a staging buffer when its first shard
    is asked for.  On CUDA the returned tensor's copy may still be in
    flight: it is ordered before any later work on the device's current
    stream, and the host waits for the copies out of a buffer (an event a
    device) only when it reuses the buffer, two chunks later.
    """

    def __init__(self, src, chunk_size: int, n_obs: int, n_draws: int, dtype: torch.dtype,
                 devices, name: str):
        if n_obs > src.n_obs:
            raise ValueError(
                f"n_obs ({n_obs}) exceeds the {src.n_obs} rows in the chunk source"
            )
        if src.n_draws != n_draws:
            raise ValueError(
                f"{name} holds {src.n_draws} draws per row, but n_draws is {n_draws}"
            )
        if isinstance(devices, torch.device):
            devices = (devices,)
        self._src = src
        self._chunk_size = chunk_size
        self._rows = chunk_size // len(devices)
        self._dtype = dtype
        self._devices = tuple(devices)
        pinned = self._devices[0].type == "cuda"  # pinned memory needs CUDA
        self._staging = [
            torch.empty((chunk_size, n_draws), dtype=src.torch_dtype, pin_memory=pinned)
            for _ in range(2)
        ]
        self._copied: list = [{}, {}]  # per buffer: device -> event after its last copy
        self._turn = 1

    def __call__(self, c: int, j: int = 0) -> torch.Tensor:
        if j == 0:
            self._turn ^= 1
            for event in self._copied[self._turn].values():
                event.synchronize()  # the copies out of this buffer have finished
            self._copied[self._turn] = {}
            self._src._read_into(c * self._chunk_size, self._staging[self._turn])
        rows = self._staging[self._turn][j * self._rows : (j + 1) * self._rows]
        device = self._devices[j]
        if device.type != "cuda":
            return rows.to(self._dtype, copy=True)
        with device_scope(device):
            shard = rows.to(device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(device))
        self._copied[self._turn][str(device)] = copied
        return shard.to(self._dtype)


def chunk_maker(fn, chunk_size: int, n_obs: int, n_draws: int, dtype: torch.dtype,
                devices, name: str):
    """``make(c, j, idx)``: shard ``j`` of chunk ``c`` of ``fn``, a generator
    called on the shard's indices ``idx`` or a disk chunk source read at row
    ``c * chunk_size``, as a ``(rows, n_draws)`` tensor of ``dtype`` on
    ``devices[j]`` (``devices`` a device or a tuple of them, one a shard;
    ``rows`` is ``chunk_size`` over their number)."""
    if isinstance(devices, torch.device):
        devices = (devices,)
    rows = chunk_size // len(devices)
    if is_chunk_source(fn):
        chunks = SourceChunks(fn, chunk_size, n_obs, n_draws, dtype, devices, name)
        return lambda c, j, idx: chunks(c, j)
    return lambda c, j, idx: generate(fn, idx, (rows, n_draws), dtype, name)
