"""Streaming LOO expectations and predictive metrics.

Counterpart of ``e_loo_streaming``, ``_eloo_chunk`` and
``loo_predictive_metric_streaming`` in ``pyloo_tpu/streaming.py``: each
chunk's log-likelihood and h(theta) samples are made on the device (or read
from disk), the rows get PSIS-smoothed weights, the expectation and its
Pareto-k diagnostic in one step, and only the ``(n_obs,)`` results are kept.
"""

from __future__ import annotations

import numpy as np

from .._common import compute_device
from ..containers import DataArray
from ..e_loo import (
    ExpectationResult,
    _convergence_rate_vectorized,
    _min_ss_vectorized,
    _pareto_khat_threshold,
)
from ..loo_predictive_metric import _accuracy, _balanced_accuracy, _mae, _mse, _rmse
from ..ops import psislw_batch, tail_length
from ..ops.expectations import khat_batch, weighted_expectation_batch
from ..parallel.sharding import as_mesh
from . import _chunks
from .loo import _as_dtype

__all__ = ["e_loo_streaming", "loo_predictive_metric_streaming"]

# bytes of one (chunk, S) tensor: the log-likelihood and h are both resident
ELOO_CHUNK_BUDGET = 1 << 30


def _eloo_chunk(ll, x, *, kind: str, tail_max: int, probs):
    """One chunk's expectation and its function-specific Pareto k."""
    log_ratios = -ll
    lw, _ = psislw_batch(log_ratios, tail_max)
    value = weighted_expectation_batch(x, lw, kind, probs)
    del lw
    if kind == "quantile":
        k = khat_batch(log_ratios, log_ratios, use_h=False)
    else:
        h = x**2 if kind in ("variance", "sd") else x
        k = khat_batch(h, log_ratios, use_h=True)
    return value, k


def e_loo_streaming(
    log_lik_fn,
    x_fn,
    n_obs: int,
    n_draws: int,
    *,
    type: str = "mean",
    probs=None,
    reff: float = 1.0,
    chunk_size: int | None = None,
    dtype=None,
    mesh=None,
    on_chunk=None,
):
    """Weighted LOO expectations (:func:`pyloo_tpu_torch.e_loo`) for data too
    large to hold as ``(n_obs, n_draws)`` matrices.

    Parameters
    ----------
    log_lik_fn : callable or NpyLogLik
        ``(chunk,) int64 -> (chunk, n_draws)`` log-likelihood on the device,
        or a disk chunk source (the contract of
        :func:`pyloo_tpu_torch.loo_streaming`).
    x_fn : callable or NpyLogLik
        The h(theta) samples whose expectation is taken (e.g.
        posterior-predictive draws), by the same contract.
    n_obs, n_draws : int
        Dataset extent.
    type : {"mean", "variance", "sd", "quantile"}
    probs : float or sequence, required for ``type="quantile"``.
    reff : float
        Relative MCMC efficiency (sizes the smoothed tail).
    chunk_size, dtype, mesh, on_chunk
        As in :func:`pyloo_tpu_torch.loo_streaming`; the default chunk keeps
        each ``(chunk, n_draws)`` tensor under ~1 GB, since two are resident.
        Over a ``mesh`` each chunk's rows are dealt over its devices.

    Returns
    -------
    ExpectationResult
        ``value`` is an ``(n_obs,)`` DataArray (``(n_obs, n_probs)`` for
        quantiles); ``pareto_k`` / ``min_ss`` / ``khat_threshold`` /
        ``convergence_rate`` as :func:`pyloo_tpu_torch.e_loo` gives them.
    """
    if type not in ("mean", "variance", "sd", "quantile"):
        raise ValueError("type must be 'mean', 'variance', 'sd' or 'quantile'")
    probs_tuple = None
    if type == "quantile":
        if probs is None:
            raise ValueError("probs must be provided for quantile calculation")
        probs_arr = np.atleast_1d(np.asarray(probs, dtype=np.float64))
        if not np.all((probs_arr > 0) & (probs_arr < 1)):
            raise ValueError("probs must be between 0 and 1")
        probs_tuple = tuple(float(p) for p in probs_arr)
    elif probs is not None:
        raise ValueError("probs is only valid for type='quantile'")
    if n_draws < 2:
        raise ValueError("PSIS requires at least 2 draws per observation.")
    if n_obs < 1:
        raise ValueError("n_obs must be positive.")
    mesh = as_mesh(mesh, "e_loo_streaming")

    device = compute_device()
    dtype = _as_dtype(dtype)
    chunk_size, n_chunks = _chunks.resolve_chunk(
        chunk_size, n_obs, n_draws, dtype, budget=ELOO_CHUNK_BUDGET, mesh=mesh
    )
    shards = _chunks.Shards(mesh, chunk_size, n_chunks, n_obs, device)
    tail_max = tail_length(n_draws, reff)
    make_ll, make_x = (
        _chunks.chunk_maker(fn, chunk_size, n_obs, n_draws, dtype, shards.devices, name)
        for fn, name in ((log_lik_fn, "log_lik_fn"), (x_fn, "x_fn"))
    )

    bufs_v = shards.buffers(dtype, () if probs_tuple is None else (len(probs_tuple),))
    bufs_k = shards.buffers(dtype)
    for c in range(n_chunks):

        def work(j, c=c):
            idx, _ = shards.indices(c, j)
            ll, x = make_ll(c, j, idx), make_x(c, j, idx)
            return lambda: _eloo_chunk(ll, x, kind=type, tail_max=tail_max, probs=probs_tuple)

        for j, (value, k) in enumerate(shards.decided(work)):
            with shards.scope(j):
                bufs_v[j][shards.part(c)], bufs_k[j][shards.part(c)] = value, k
        if on_chunk is not None:
            on_chunk(c + 1, n_chunks)

    value_host = shards.host(bufs_v)
    k_host = shards.host(bufs_k).astype(np.float64)

    k_da = DataArray(k_host, ("obs",), name="pareto_k")
    if probs_tuple is None:
        value_da = DataArray(value_host, ("obs",), name=type)
    else:
        value_da = DataArray(
            value_host, ("obs", "quantile"), {"quantile": np.asarray(probs_tuple)}, name=type
        )
    return ExpectationResult(
        value=value_da,
        pareto_k=k_da,
        min_ss=DataArray(_min_ss_vectorized(k_host), ("obs",)),
        khat_threshold=DataArray(np.full(n_obs, _pareto_khat_threshold(n_draws)), ("obs",)),
        convergence_rate=DataArray(_convergence_rate_vectorized(k_host, n_draws), ("obs",)),
    )


def loo_predictive_metric_streaming(
    log_lik_fn,
    x_fn,
    y,
    n_obs: int,
    n_draws: int,
    *,
    metric: str = "mae",
    r_eff: float = 1.0,
    chunk_size: int | None = None,
    dtype=None,
    mesh=None,
    on_chunk=None,
):
    """LOO predictive point metric (:func:`pyloo_tpu_torch.loo_predictive_metric`)
    for data too large to hold as matrices: the PSIS-weighted LOO predictive
    mean streams through :func:`e_loo_streaming`, then the metric and its SE
    are the in-memory path's host arithmetic.

    ``x_fn`` makes the posterior-predictive samples (the contract of
    ``log_lik_fn``); ``y`` is the length-``n_obs`` observed vector, on the
    host.
    """
    y = np.asarray(y).ravel()
    if len(y) != n_obs:
        raise ValueError(f"Length of y ({len(y)}) must match n_obs ({n_obs})")
    scorers = {
        "mae": _mae,
        "mse": _mse,
        "rmse": _rmse,
        "acc": _accuracy,
        "balanced_acc": _balanced_accuracy,
    }
    if metric not in scorers:
        raise ValueError(
            f"Invalid metric: {metric}. Must be one of: 'mae', 'mse', 'rmse',"
            " 'acc', 'balanced_acc'"
        )
    pred = e_loo_streaming(
        log_lik_fn, x_fn, n_obs, n_draws, type="mean", reff=r_eff, chunk_size=chunk_size,
        dtype=dtype, mesh=mesh, on_chunk=on_chunk,
    )
    return scorers[metric](y, np.asarray(pred.value.values, np.float64))
