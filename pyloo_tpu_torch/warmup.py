"""Cold-start control: first use of the device before the data arrives.

Counterpart of ``pyloo_tpu/warmup.py``.  On a CUDA device the first call of
a process pays for the CUDA context, the build or load of this package's
kernel library (:mod:`pyloo_tpu_torch._build`) and the caching allocator's
first blocks.  :func:`warmup` pays them ahead of time by pushing one
synthetic chunk through :func:`pyloo_tpu_torch.loo_streaming` at the chunk
geometry a real ``(n_obs, n_draws)`` sweep resolves.

Not ported, as JAX or TPU artefacts: the persistent XLA compilation cache
and the detection of the remote-compile TPU plugin, and the warmup that
``pyloo_tpu`` configures at import.  Nothing here runs at import.  The
kernel library, named by a hash of its sources in ``build/pyloo_tpu_torch/``,
is this package's persistent cache: a later process loads it without
compiling.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from . import _build
from ._common import compute_device
from .parallel.sharding import as_mesh
from .streaming._chunks import resolve_chunk
from .streaming.loo import _as_dtype, loo_streaming

__all__ = ["warmup"]


class _ZeroSource:
    """Minimal in-memory chunk source (the disk-source protocol) for warmup."""

    def __init__(self, n_obs, n_draws, dtype):
        self.n_obs = n_obs
        self.n_draws = n_draws
        self.torch_dtype = dtype

    def read_rows(self, start, n_rows):
        base = np.arange(n_rows, dtype=np.float64)[:, None] * 1e-3
        sweep = np.arange(self.n_draws, dtype=np.float64)[None, :] * 1e-4
        return -1.0 - base - sweep

    def _read_into(self, start, out):
        out.copy_(torch.from_numpy(self.read_rows(start, out.shape[0])))


def warmup(
    n_obs: int,
    n_draws: int,
    *,
    chunk_size: int | None = None,
    dtype=None,
    method: str = "psis",
    reff: float = 1.0,
    pointwise: bool = False,
    mixture: bool = False,
    mesh=None,
    source: bool = False,
) -> dict:
    """Make the device ready for a streaming LOO sweep of one geometry.

    Runs one synthetic chunk through :func:`pyloo_tpu_torch.loo_streaming`
    with exactly the chunk geometry a real ``(n_obs, n_draws)`` sweep would
    resolve, on ``rcParams["device.device"]`` (over ``mesh``, on each of its
    devices).  On a CUDA device in float32 it first loads the kernel library
    (:func:`pyloo_tpu_torch._build.load`), building it from the package's
    sources if no library for them exists yet, and the chunk launches the
    fused prepass kernel; the float64 path uses no kernel of the library and
    loads nothing.  The first real call then pays neither the CUDA context,
    nor the build, nor the allocator's first blocks.

    The arguments are those of ``pyloo_tpu.warmup``: ``chunk_size`` (or the
    default geometry derived from ``n_obs``), ``dtype`` (or
    ``rcParams['device.precision']``), ``method``, ``reff``, ``pointwise``,
    ``mixture``; ``source=True`` runs the chunk through the disk-source path
    (``loo_from_file`` / ``NpyLogLik``); ``mesh`` as in ``loo_streaming``.

    Returns a dict with the resolved geometry, the warmup wall time
    (``wall_s``) and ``compilation_cache``: True when the kernel library was
    loaded (already in this process, or from its hash-named file) rather
    than compiled by this call; False when the warmed path uses no library
    (on the CPU, or in float64).
    ``pyloo_tpu``'s key of that name says whether the persistent XLA cache
    is on.

    Example
    -------
    >>> pl.warmup(1_000_000, 4000, dtype=torch.float32)   # at service startup
    >>> pl.loo_streaming(my_log_lik, 1_000_000, 4000, dtype=torch.float32)
    """
    mesh = as_mesh(mesh, "warmup")
    dtype = _as_dtype(dtype)
    chunk_size, _ = resolve_chunk(chunk_size, n_obs, n_draws, dtype, mesh=mesh)

    t0 = time.perf_counter()
    device = compute_device()
    cached = False
    if device.type == "cuda" and dtype == torch.float32:  # float64 launches no kernel
        cached = _build.is_built()
        _build.load()
    if source:
        fn = _ZeroSource(chunk_size, n_draws, dtype)
    else:
        def fn(idx):  # deterministic, non-constant rows
            base = -1.0 - idx.to(dtype)[:, None] * 1e-3
            sweep = torch.arange(n_draws, dtype=dtype, device=idx.device)[None, :] * 1e-4
            return base - sweep

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # mixture advisory, degenerate-k etc.
        loo_streaming(
            fn,
            chunk_size,  # one chunk
            n_draws,
            reff=reff,
            chunk_size=chunk_size,
            pointwise=pointwise,
            method=method,
            mixture=mixture,
            dtype=dtype,
            mesh=mesh,
        )
    wall = time.perf_counter() - t0
    return {
        "chunk_size": chunk_size,
        "n_draws": n_draws,
        "dtype": str(dtype).removeprefix("torch."),
        "method": method,
        "pointwise": pointwise,
        "mixture": mixture,
        "source": source,
        "wall_s": wall,
        "compilation_cache": cached,
    }
