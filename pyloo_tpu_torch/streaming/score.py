"""Streaming LOO-CRPS / LOO-SCRPS.

Counterpart of ``loo_score_streaming`` in ``pyloo_tpu/streaming.py``: three
generators make the log-likelihood and the two predictive sample sets of a
chunk on the device, and the chunk is scored by the function
:func:`pyloo_tpu_torch.loo_score` uses (``loo_score._crps_chunk``).
"""

from __future__ import annotations

import numpy as np
import torch

from .._common import compute_device
from ..loo_score import LooScoreResult, _crps_chunk, _estimates, _warn_high_k, draw_permutations
from ..ops import tail_length
from ..parallel.sharding import as_mesh
from . import _chunks
from .loo import _as_dtype

__all__ = ["loo_score_streaming"]

# bytes of one (chunk, S) tensor: three are resident a step, as in pyloo_tpu
SCORE_CHUNK_BUDGET = 700 << 20


def loo_score_streaming(
    log_lik_fn,
    x_fn,
    x2_fn,
    y,
    n_obs: int,
    n_draws: int,
    *,
    permutations: int = 1,
    reff: float = 1.0,
    scale: bool = False,
    seed: int | None = None,
    chunk_size: int | None = None,
    dtype=None,
    mesh=None,
    on_chunk=None,
):
    """LOO-CRPS / LOO-SCRPS (:func:`pyloo_tpu_torch.loo_score`) for data too
    large to hold as matrices.

    ``x_fn`` / ``x2_fn`` make the two independent predictive sample sets
    (``(chunk,) int64 -> (chunk, n_draws)`` on the device, the contract of
    ``log_lik_fn`` in :func:`pyloo_tpu_torch.loo_streaming`, a disk chunk
    source included); ``y`` is the
    length-``n_obs`` observed vector.  The draw permutations pairing x with
    x2 are drawn once on the host from ``np.random.default_rng(seed)`` and
    shared by every chunk, as :func:`loo_score` draws them.  Over a ``mesh``
    each chunk's rows are dealt over its devices.

    Returns :class:`~pyloo_tpu_torch.loo_score.LooScoreResult` with the
    pointwise scores and Pareto k as ``(n_obs,)`` float64 arrays.
    """
    if n_draws < 2:
        raise ValueError("PSIS requires at least 2 draws per observation.")
    if n_obs < 1:
        raise ValueError("n_obs must be positive.")
    if permutations < 1:
        raise ValueError("permutations must be a positive integer")
    y = np.asarray(y).ravel()
    if len(y) != n_obs:
        raise ValueError(f"Length of y ({len(y)}) must match n_obs ({n_obs})")
    mesh = as_mesh(mesh, "loo_score_streaming")

    device = compute_device()
    dtype = _as_dtype(dtype)
    chunk_size, n_chunks = _chunks.resolve_chunk(
        chunk_size, n_obs, n_draws, dtype, budget=SCORE_CHUNK_BUDGET, mesh=mesh
    )
    shards = _chunks.Shards(mesh, chunk_size, n_chunks, n_obs, device)
    tail_max = tail_length(n_draws, reff)
    perms = torch.from_numpy(draw_permutations(seed, permutations, n_draws))
    y_pad = np.zeros(n_chunks * chunk_size)
    y_pad[:n_obs] = y.astype(np.float64)
    ys = shards.split(y_pad, dtype)

    make_ll, make_x, make_x2 = (
        _chunks.chunk_maker(fn, chunk_size, n_obs, n_draws, dtype, shards.devices, name)
        for fn, name in ((log_lik_fn, "log_lik_fn"), (x_fn, "x_fn"), (x2_fn, "x2_fn"))
    )
    bufs_s, bufs_k = shards.buffers(dtype), shards.buffers(dtype)
    for c in range(n_chunks):

        def work(j, c=c):
            idx, _ = shards.indices(c, j)
            ll, x, x2 = make_ll(c, j, idx), make_x(c, j, idx), make_x2(c, j, idx)
            y_j, perms_j = ys[j][shards.part(c)], shards.on(perms, j)
            return lambda: _crps_chunk(ll, x, x2, y_j, perms_j, tail_max=tail_max, scale=scale)

        for j, (score, k) in enumerate(shards.decided(work)):
            with shards.scope(j):
                bufs_s[j][shards.part(c)], bufs_k[j][shards.part(c)] = score, k
        if on_chunk is not None:
            on_chunk(c + 1, n_chunks)

    score_pw = shards.host(bufs_s).astype(np.float64)
    pareto_k = shards.host(bufs_k).astype(np.float64)
    result = LooScoreResult(estimates=_estimates(score_pw), pointwise=score_pw)
    _warn_high_k(result, pareto_k, n_draws)
    return result
