"""Host arrays onto a CUDA device through a ring of pinned staging buffers.

``Tensor.to(device)`` of a pageable host array in one piece has the driver
stage it through its own pinned memory on one host thread: ~5-6 GB/s on an
H100's host, where a copy from pinned memory runs at 43-55 GB/s.
:func:`to_device` instead walks the array's bytes in slabs of
:data:`SLAB_BYTES`.  Each slab is filled into a buffer of a ring of pinned
buffers by one of :data:`FILL_THREADS` host threads, which fill several
slabs at once (numpy's copy releases the interpreter lock), and the buffer
is copied to the slab's place on the device with ``non_blocking=True`` on
the current stream.  A buffer is refilled only once the event recorded
after its copy has passed, as ``streaming._chunks.SourceChunks`` does for
disk chunks.  The ring is made at a device's first staged copy and kept for
the process; a lock keeps two calling threads off one ring.

The route changes no value: the device tensor is ``torch.from_numpy(a).to(
device, dtype)``'s bit for bit (a cast to ``dtype`` happens on the host as
the slab is filled, where the blocking ``.to`` casts too).  It engages where
it pays, a CUDA device and a payload of two slabs or more; anything else
takes ``Tensor.to``.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .profiling import count

__all__ = ["to_device"]

SLAB_BYTES = 16 << 20  # a buffer of the ring, filled by one thread
RING_BUFFERS = 16  # 256 MiB pinned a device
FILL_THREADS = min(8, len(os.sched_getaffinity(0)))
# dtypes numpy holds, so that its threads can fill (and cast) a slab
_HOST_DTYPES = (torch.float16, torch.float32, torch.float64)


class Ring:
    """:data:`RING_BUFFERS` staging buffers of ``slab_bytes`` for copies to
    ``device`` (pinned where it is a CUDA device), the event recorded after
    each buffer's last copy out, and the threads that fill them."""

    def __init__(self, device: torch.device, slab_bytes: int = SLAB_BYTES):
        pinned = device.type == "cuda"  # pinned memory needs CUDA
        self.slab_bytes = slab_bytes
        self.buffers = [torch.empty(slab_bytes, dtype=torch.uint8, pin_memory=pinned)
                        for _ in range(RING_BUFFERS)]
        self.copied: list = [None] * RING_BUFFERS
        self.lock = threading.Lock()
        self.pool = ThreadPoolExecutor(FILL_THREADS, thread_name_prefix="pyloo-stage")

    def close(self) -> None:
        """Stop the fill threads (a ring of :func:`ring_for` lives as long
        as the process)."""
        self.pool.shutdown()


_RINGS: dict = {}
_RINGS_LOCK = threading.Lock()


def ring_for(device: torch.device) -> Ring:
    """The process's ring for ``device``, made at its first use."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _RINGS_LOCK:
        ring = _RINGS.get(device)
        if ring is None:
            ring = _RINGS[device] = Ring(device)
        return ring


def copy_into(dst: torch.Tensor, src: np.ndarray, ring: Ring) -> None:
    """Copy the C-contiguous host array ``src`` into the contiguous tensor
    ``dst`` of as many elements through ``ring``, cast to ``dst``'s dtype as
    each slab is filled.

    The fills of the next ``RING_BUFFERS - 1`` slabs are queued on the
    ring's threads, one thread a slab, while the host copies filled slabs
    out in order, so no thread waits for another.  On CUDA the last copies
    may still be in flight when this returns: they are ordered before any
    later work on ``dst``'s device's current stream."""
    flat_src = src.reshape(-1)
    flat_dst = dst.view(-1)
    n = flat_src.size
    if n != flat_dst.numel():
        raise ValueError(f"{n} host elements for {flat_dst.numel()} in dst")
    per_slab = ring.slab_bytes // dst.element_size()
    n_slabs = -(-n // per_slab)
    filling: deque = deque()  # (slab, its stage, the fill's future), in slab order

    def fill(k: int) -> None:
        b = k % RING_BUFFERS
        if ring.copied[b] is not None:
            ring.copied[b].synchronize()  # the copy out of this buffer has finished
        lo, hi = k * per_slab, min((k + 1) * per_slab, n)
        stage = ring.buffers[b][: (hi - lo) * dst.element_size()].view(dst.dtype)
        filling.append((k, stage, ring.pool.submit(
            np.copyto, stage.numpy(), flat_src[lo:hi], casting="unsafe")))

    with ring.lock:
        try:
            for k in range(min(RING_BUFFERS - 1, n_slabs)):
                fill(k)
            while filling:
                k, stage, filled = filling.popleft()
                filled.result()
                flat_dst[k * per_slab : k * per_slab + stage.numel()].copy_(
                    stage, non_blocking=True)
                if dst.device.type == "cuda":
                    ring.copied[k % RING_BUFFERS] = torch.cuda.Event()
                    ring.copied[k % RING_BUFFERS].record(torch.cuda.current_stream(dst.device))
                if k + RING_BUFFERS - 1 < n_slabs:
                    fill(k + RING_BUFFERS - 1)
        finally:  # no fill may write a buffer once the ring is released
            for _, _, filled in filling:
                if not filled.cancel():
                    filled.exception()


def _pays(device: torch.device, nbytes: int) -> bool:
    """Whether the ring is the faster route: a copy to a CUDA device of two
    slabs or more (a smaller one is over before the ring's threads start)."""
    return device.type == "cuda" and nbytes >= 2 * SLAB_BYTES


def to_device(src: torch.Tensor, device: torch.device,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """``src.to(device, dtype)`` bit for bit (``dtype`` defaults to
    ``src``'s): through :func:`ring_for`'s ring where :func:`_pays` says so
    and numpy holds both dtypes, counting the host bytes that went through
    it as ``h2d_staged_bytes``; by ``Tensor.to`` otherwise."""
    dtype = src.dtype if dtype is None else dtype
    nbytes = src.numel() * src.element_size()
    if not (src.device.type == "cpu" and _pays(device, nbytes)
            and src.dtype in _HOST_DTYPES and dtype in _HOST_DTYPES):
        return src.to(device, dtype)
    dst = torch.empty(src.shape, dtype=dtype, device=device)
    copy_into(dst, src.contiguous().numpy(), ring_for(device))
    count("h2d_staged_bytes", "ingest", nbytes)
    return dst
