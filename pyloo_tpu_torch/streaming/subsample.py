"""Streaming subsampled LOO and streaming LOO for approximate posteriors.

Counterpart of ``loo_subsample_streaming``, ``_lpd_chunk`` and
``loo_approximate_posterior_streaming`` in ``pyloo_tpu/streaming.py``.  The
subsampled estimator streams the cheap LPD approximation of every
observation chunk by chunk, draws the subsample on the host from numpy's
random streams (the same rows as ``pyloo_tpu`` for the same seed), and
scores only the sampled rows exactly, in float64 on the device.  The
approximate-posterior form resamples the draws once on the host and applies
the reindex to every chunk of :func:`loo_streaming` on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._common import compute_device, resolve_scale
from ..base import ISMethod
from ..constants import EstimatorMethod
from ..estimators import SubsampleIndices, subsample_indices
from ..loo_approximate_posterior import _validated_resample_indices, _warn_non_psis
from ..loo_subsample import _score_sampled, _subsample_result
from ..ops.lse import logsumexp
from ..parallel.sharding import as_mesh
from . import _chunks
from .loo import _as_dtype, loo_streaming

__all__ = ["loo_subsample_streaming", "loo_approximate_posterior_streaming"]


def _sampled_rows(log_lik_fn, idx: np.ndarray, n_draws: int, device) -> torch.Tensor:
    """The ``(m, n_draws)`` float64 log-likelihood of the rows ``idx`` on the
    device: one generator call, or the disk source's random-access read."""
    if _chunks.is_chunk_source(log_lik_fn):
        rows = torch.from_numpy(log_lik_fn.gather_rows(idx))
        return rows.to(device).to(torch.float64)
    idx_t = torch.as_tensor(idx, dtype=torch.int64, device=device)
    return _chunks.generate(log_lik_fn, idx_t, (len(idx), n_draws), torch.float64, "log_lik_fn")


def loo_subsample_streaming(
    log_lik_fn,
    n_obs: int,
    n_draws: int,
    observations=400,
    *,
    estimator: str = "diff_srs",
    elpd_loo_approximation=None,
    reff: float = 1.0,
    chunk_size: int | None = None,
    pointwise: bool = False,
    scale: str | None = None,
    dtype=None,
    mesh=None,
    seed: int | None = None,
):
    """Subsampled LOO (:func:`pyloo_tpu_torch.loo_subsample`, reference
    ``pyloo/loo_subsample.py:120-539``) over a streamed log-likelihood.

    The LPD of every observation, made chunk by chunk from ``log_lik_fn``
    (the contract of :func:`loo_streaming`, a disk chunk source included),
    ranks or weights all ``n_obs`` observations; exact float64 PSIS-LOO then
    runs on the ``observations`` sampled rows only (one ``log_lik_fn`` call,
    or the source's ``gather_rows``), and the survey estimator (diff_srs /
    hh_pps / srs) gives the population elpd with a subsampling SE.  Pass
    ``elpd_loo_approximation`` (an ``(n_obs,)`` array) to skip the LPD pass.
    Over a ``mesh`` the LPD pass deals each chunk's rows over its devices,
    and the sampled rows are scored over it as :func:`loo` scores rows.

    Returns ELPDData with the same rows as :func:`pyloo_tpu_torch.loo_subsample`.
    For :func:`pyloo_tpu_torch.update_subsample`, the result keeps
    ``log_lik_fn`` and the ``(n_obs,)`` approximation vector in
    ``result.estimates.stream``; ``del result.estimates.stream`` releases
    both if you will not update.
    """
    if estimator is None:
        estimator = "diff_srs"
    try:
        est_method = EstimatorMethod(estimator.lower())
    except ValueError:
        raise ValueError(
            f"Invalid estimator '{estimator}'. "
            f"Must be one of: {', '.join(m.value for m in EstimatorMethod)}"
        )
    scale, scale_value = resolve_scale(scale)
    if n_draws < 2:
        raise ValueError("PSIS requires at least 2 draws per observation.")
    if n_obs < 1:
        raise ValueError("n_obs must be positive.")
    mesh = as_mesh(mesh, "loo_subsample_streaming")
    device = compute_device()
    dtype = _as_dtype(dtype)

    if isinstance(observations, (int, np.integer)):
        if observations <= 0 or observations > n_obs:
            raise ValueError(
                f"Number of observations must be between 1 and {n_obs}, "
                f"got {observations}"
            )
    elif isinstance(observations, np.ndarray):
        if not np.issubdtype(observations.dtype, np.integer):
            raise TypeError("observations array must contain integers")
        if observations.min() < 0 or observations.max() >= n_obs:
            raise ValueError(
                f"Observation indices must be between 0 and {n_obs - 1}, "
                f"got range [{observations.min()}, {observations.max()}]"
            )
    else:
        raise TypeError("observations must be an integer or an array of integers")

    chunk_size, n_chunks = _chunks.resolve_chunk(chunk_size, n_obs, n_draws, dtype, mesh=mesh)

    # -- cheap approximation for every observation (streamed LPD) ------------
    if elpd_loo_approximation is not None:
        elpd_loo_approx = np.asarray(elpd_loo_approximation, np.float64).ravel()
        if elpd_loo_approx.shape[0] != n_obs:
            raise ValueError(
                f"elpd_loo_approximation must have length {n_obs}, "
                f"got {elpd_loo_approx.shape[0]}"
            )
    else:
        shards = _chunks.Shards(mesh, chunk_size, n_chunks, n_obs, device)
        make = _chunks.chunk_maker(log_lik_fn, chunk_size, n_obs, n_draws, dtype,
                                   shards.devices, "log_lik_fn")
        bufs = shards.buffers(dtype)
        for c in range(n_chunks):
            for j, _ in shards:
                with shards.scope(j):
                    idx, _ = shards.indices(c, j)
                    bufs[j][shards.part(c)] = logsumexp(make(c, j, idx), dim=1, b_inv=n_draws)
        elpd_loo_approx = shards.host(bufs).astype(np.float64)

    # -- draw the subsample ---------------------------------------------------
    if isinstance(observations, np.ndarray):
        indices = SubsampleIndices(idx=observations, m_i=np.ones_like(observations))
    else:
        rng = np.random.default_rng(seed) if seed is not None else None
        indices = subsample_indices(
            estimator=est_method.value,
            elpd_loo_approximation=elpd_loo_approx,
            observations=int(observations),
            rng=rng,
        )

    # -- exact float64 PSIS-LOO on the m sampled rows, and the estimates ------
    ll_sample = _sampled_rows(log_lik_fn, np.asarray(indices.idx), n_draws, device)
    loo_lppd_i, diagnostic, p_loo_values = _score_sampled(
        ll_sample, reff, scale_value, mesh, decide_over="call"
    )
    del ll_sample
    loo_lppd_i_full = None
    if pointwise:
        loo_lppd_i_full = np.full(n_obs, np.nan)
        loo_lppd_i_full[indices.idx] = loo_lppd_i
    result = _subsample_result(
        est_method, elpd_loo_approx, indices, loo_lppd_i, diagnostic, p_loo_values,
        n_draws, n_obs, scale, loo_lppd_i_full,
    )
    result.estimates.loo_approximation = (
        "custom" if elpd_loo_approximation is not None else "lpd"
    )
    result.estimates.estimator = est_method.value
    # the stream's parameters let update_subsample() dispatch here again,
    # reusing the (n_obs,) approximation so an update makes only the new
    # subsample's rows
    result.estimates.stream = dict(
        log_lik_fn=log_lik_fn, n_obs=n_obs, n_draws=n_draws,
        elpd_loo_approximation=elpd_loo_approx, reff=reff,
        chunk_size=chunk_size, dtype=dtype, mesh=mesh,
    )
    return result


def loo_approximate_posterior_streaming(
    log_lik_fn,
    log_p,
    log_q,
    n_obs: int,
    n_draws: int,
    *,
    reff: float = 1.0,
    chunk_size: int | None = None,
    pointwise: bool = False,
    method: str | ISMethod = "psis",
    resample_method: str = "psis",
    seed: int | None = None,
    scale: str | None = None,
    dtype=None,
    mesh=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 64,
    on_chunk=None,
):
    """LOO-CV with a posterior-approximation correction
    (:func:`pyloo_tpu_torch.loo_approximate_posterior`) over a streamed
    log-likelihood.

    ``log_p`` (target) and ``log_q`` (proposal) are length-``n_draws``
    vectors at the proposal draws.  The draw resample
    (:func:`pyloo_tpu_torch.importance_resample`) runs once on the host,
    giving the in-memory path's indices at equal ``seed``, and the reindex
    is applied to each chunk on the device.  All other options behave as
    :func:`loo_streaming`.  A checkpoint requires an explicit ``seed`` (the
    resample must be the same on resume); the CRC of the resampled indices
    is part of the checkpoint geometry, so a resume whose resample differs
    is rejected.

    Returns the ELPDData of :func:`loo_streaming` with the
    ``approximate_posterior`` attribute.
    """
    method_is = ISMethod(method.lower() if isinstance(method, str) else method)
    if method_is != ISMethod.PSIS:
        _warn_non_psis(method_is)
    if checkpoint_path is not None and seed is None:
        raise ValueError(
            "checkpoint_path requires an explicit seed: the draw resample"
            " must be reproducible for a resumed run to be consistent."
        )

    log_p, log_q, indices = _validated_resample_indices(
        log_p, log_q, method=resample_method, seed=seed, n_draws=n_draws
    )
    result = loo_streaming(
        log_lik_fn,
        n_obs,
        n_draws,
        _column_gather=indices,
        reff=reff,
        chunk_size=chunk_size,
        pointwise=pointwise,
        method=method_is,
        scale=scale,
        dtype=dtype,
        mesh=mesh,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
        on_chunk=on_chunk,
    )
    result.approximate_posterior = {"log_p": log_p, "log_q": log_q}
    return result
