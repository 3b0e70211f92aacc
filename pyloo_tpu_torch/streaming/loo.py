"""Streaming PSIS-LOO for data too large to hold as one matrix.

Counterpart of ``loo_streaming`` in ``pyloo_tpu/streaming.py``.  The model
lives on the device, and its log-likelihood is a function of the observation
index, called once per chunk of rows; each chunk is scored and folded into a
running carry on the device, so only O(chunk) memory is live and nothing
crosses to the host until the end::

    def log_lik_fn(idx):          # (chunk,) int64 indices on the device
        eta = x[idx] @ beta.T     # x, y, beta: tensors on the device
        return y[idx, None] * eta - torch.logaddexp(eta, torch.zeros(()))

    res = pyloo_tpu_torch.loo_streaming(log_lik_fn, n_obs, n_draws, dtype="float32")

``log_lik_fn`` may also be a disk chunk source
(:class:`pyloo_tpu_torch.io.NpyLogLik`), read chunk by chunk on the host and
copied to the device.

Over a ``mesh`` (:func:`pyloo_tpu_torch.parallel.obs_mesh`) each chunk's rows
are dealt over its devices: ``log_lik_fn`` is called once a shard with the
shard's indices on the shard's device and must return rows there, so a model
held on one card keeps a copy on each, keyed on ``idx.device``::

    copies = {d: (x.to(d), y.to(d), beta.to(d)) for d in mesh.devices}

    def log_lik_fn(idx):
        x, y, beta = copies[idx.device]
        ...

Each device keeps its own carry; the carries are combined as scalars at the
end.  ``pyloo_tpu``'s generator program cache and its tiled chunk layout
are JAX and TPU devices with no counterpart under eager torch.
"""

from __future__ import annotations

import contextlib
import os
import warnings
import zlib

import numpy as np
import torch

from .._common import compute_device, good_k_threshold, resolve_scale
from ..base import ISMethod
from ..containers import DataArray
from ..loo import _assemble
from ..ops import tail_length
from ..parallel.sharding import as_mesh
from ..rcparams import rcParams
from . import _accumulate, _checkpoint, _chunks

__all__ = ["loo_streaming", "clear_streaming_cache"]


def clear_streaming_cache(log_lik_fn=None) -> None:
    """Does nothing; kept so that code written for ``pyloo_tpu`` runs unchanged.

    ``pyloo_tpu`` memoizes a traced generator program per ``log_lik_fn``,
    with the arrays it captured baked in, and this call drops it.  Here the
    generator runs eagerly at every chunk and reads its tensors as they are,
    so there is nothing to drop.
    """
    del log_lik_fn


def _save(path, geometry, chunk, carries, shards, bufs_e, bufs_d) -> None:
    """A checkpoint of the shards' state as one: the carries combined, the
    pointwise buffers in row order (the layout of a run with no mesh)."""
    carry = {k: torch.tensor(v, dtype=carries[0][k].dtype)
             for k, v in _accumulate.combine_carries(carries).items()}
    buf_e = buf_d = None
    if bufs_e is not None:
        n_rows = shards.n_chunks * shards.chunk_size
        buf_e = torch.from_numpy(shards.host(bufs_e, n_rows))
        buf_d = torch.from_numpy(shards.host(bufs_d, n_rows))
    _checkpoint.save_checkpoint(path, geometry, chunk, carry, buf_e, buf_d)


def _as_dtype(dtype) -> torch.dtype:
    if dtype is None:
        dtype = rcParams["device.precision"]
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"dtype must be float32 or float64, got {name}")
    return getattr(torch, name)


def loo_streaming(
    log_lik_fn,
    n_obs: int,
    n_draws: int,
    *,
    reff: float = 1.0,
    chunk_size: int | None = None,
    pointwise: bool = False,
    method: str | ISMethod = "psis",
    mixture: bool = False,
    jacobian_fn=None,
    scale: str | None = None,
    dtype=None,
    mesh=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 64,
    on_chunk=None,
    _column_gather=None,
):
    """LOO-CV over ``n_obs`` observations whose log-likelihood is computed
    on the device by ``log_lik_fn``; no (n_obs, n_draws) matrix is built.

    ``_column_gather`` (internal) is an ``(n_draws,)`` int draw reindex
    applied to each generated chunk on the device; its CRC is recorded in the
    checkpoint geometry so a resume with a different reindex is rejected.

    Parameters
    ----------
    log_lik_fn : callable or NpyLogLik
        Maps a ``(rows,)`` int64 tensor of observation indices ``idx`` (a
        ragged last chunk repeats index ``n_obs - 1``) to the
        ``(rows, n_draws)`` log-likelihood of those observations, a tensor
        on ``idx.device``; a tensor elsewhere raises.  Called once per chunk
        with the chunk's indices on ``rcParams["device.device"]``, or over a
        ``mesh`` once per chunk and shard with the shard's indices on the
        shard's device; it is cast to ``dtype``.
        Or a disk chunk source with at least ``n_obs`` rows of ``n_draws``
        draws (:class:`pyloo_tpu_torch.io.NpyLogLik`).
    n_obs, n_draws : int
        Dataset extent.  ``n_draws`` must be at least 2.
    reff : float
        Relative MCMC efficiency (reference ``pyloo/loo.py:115``).
    chunk_size : int, optional
        Rows per step.  The default takes the fewest chunks that keep each
        chunk's log-likelihood under ~2 GB and splits the sweep evenly
        across them, rounded to a multiple of 8 (of ``lcm(8, mesh.size)``
        over a mesh).  A checkpoint resume must use the chunk size its file
        was written with.
    pointwise : bool
        Also return per-observation ``loo_i`` and diagnostics (adds an
        ``(n_obs,)`` device buffer and one host copy).
    method : {"psis", "sis", "tis"}
    mixture : bool
        Mix-IS-LOO (Silva & Zanella 2022) for draws from a mixture of
        leave-one-out posteriors (reference ``pyloo/loo.py:252-284``), in one
        pass with a running normalizer.  ``method`` is ignored and the
        diagnostic is zero, as in :func:`pyloo_tpu_torch.loo`.
    jacobian_fn : callable, optional
        ``(rows,) int64 -> (rows,)`` Jacobian adjustment for a transformed
        response (reference ``pyloo/loo.py:414-439``), in the units of the
        scaled pointwise elpd, on ``idx.device`` as the chunks.
    scale : {"log", "negative_log", "deviance"}, optional
    dtype : optional
        Computation dtype (``"float32"``, ``"float64"``, a numpy or torch
        dtype); defaults to ``rcParams["device.precision"]``.  float32 takes
        the fast PSIS path through the CUDA prepass kernel, float64 the
        reference-exact one.
    mesh : Mesh, optional
        :class:`pyloo_tpu_torch.parallel.Mesh` of devices; each chunk's rows
        are dealt over them in equal blocks, each scored on its device.
        Per-row results equal the run with no mesh bit for bit: the float64
        deep-tail guard decides over the whole chunk, as ``pyloo_tpu``
        does.
    checkpoint_path : str, optional
        Save the carry (and the pointwise buffers) to this file every
        ``checkpoint_every`` chunks, atomically; if the file exists and its
        geometry matches, the run resumes from the saved chunk.  Each save
        waits for the queued chunks.  The file is removed on success.
    checkpoint_every : int
        Chunks between checkpoint saves (default 64).
    on_chunk : callable, optional
        Progress hook ``on_chunk(next_chunk_index, n_chunks)`` called on the
        host after each chunk is queued (it does not wait for the device).

    Returns
    -------
    ELPDData with the same rows as :func:`pyloo_tpu_torch.loo`.
    """
    method = ISMethod(method.lower() if isinstance(method, str) else method)
    scale, scale_value = resolve_scale(scale)
    if n_draws < 2:
        raise ValueError("PSIS requires at least 2 draws per observation.")
    if n_obs < 1:
        raise ValueError("n_obs must be positive.")
    mesh = as_mesh(mesh, "loo_streaming")

    device = compute_device()
    dtype = _as_dtype(dtype)
    dtype_name = str(dtype).removeprefix("torch.")
    chunk_size, n_chunks = _chunks.resolve_chunk(chunk_size, n_obs, n_draws, dtype, mesh=mesh)
    tail_max = tail_length(n_draws, reff)
    shards = _chunks.Shards(mesh, chunk_size, n_chunks, n_obs, device)

    good_k = good_k_threshold(n_draws)
    if mixture:
        warnings.warn(
            "Mix-IS-LOO requires a model that is sampled from a mixture of"
            " leave-one-out posteriors. Ensure the log-likelihood generator"
            " passed to `loo_streaming` comes from a model that is sampled"
            " from such a distribution.",
            UserWarning,
            stacklevel=2,
        )
    carries = [_accumulate.init_carry(method, mixture, dtype, good_k, d) for d in shards.devices]

    bufs_e = bufs_d = None
    if pointwise:
        bufs_e, bufs_d = shards.buffers(dtype), shards.buffers(dtype)

    if checkpoint_path is not None and checkpoint_every < 1:
        raise ValueError("checkpoint_every must be a positive chunk count")
    col_idx = None
    if _column_gather is not None:
        col_idx = torch.as_tensor(np.asarray(_column_gather), dtype=torch.int64, device=device)

    geometry = dict(
        n_obs=n_obs, n_draws=n_draws, chunk_size=chunk_size,
        method=method.value, dtype=dtype_name, pointwise=int(pointwise),
        scale=scale, mixture=int(mixture),
        jacobian=int(jacobian_fn is not None),
        colgather=(
            0 if _column_gather is None
            else zlib.crc32(np.ascontiguousarray(_column_gather, np.int64).tobytes())
        ),
    )

    start_chunk = 0
    if checkpoint_path is not None:
        loaded = _checkpoint.load_checkpoint(checkpoint_path, geometry, shards.devices[0])
        if loaded is not None:
            start_chunk = loaded["chunk"]
            carries[0] = loaded["carry"]  # the other shards' carries start afresh
            if pointwise:
                bufs_e = shards.split(loaded["buf_e"].cpu().numpy(), dtype)
                bufs_d = shards.split(loaded["buf_d"].cpu().numpy(), dtype)

    # One host loop of queued device work chained by the carries; no device
    # value is read until the end (checkpoint saves aside) but, in float64,
    # the deep-tail guard's flags of each chunk, once, after every shard of
    # the chunk is queued.  Every shard of a chunk is queued on its device
    # before the next chunk.
    make = _chunks.chunk_maker(log_lik_fn, chunk_size, n_obs, n_draws, dtype, shards.devices,
                               "log_lik_fn")
    for c in range(start_chunk, n_chunks):

        def work(j, c=c):
            idx, valid = shards.indices(c, j)
            ll = make(c, j, idx)
            if col_idx is not None:
                ll = _chunks.gather_cols(ll, shards.on(col_idx, j))
            adj = None
            if jacobian_fn is not None:
                # adjustments arrive in scaled-elpd units; store them in raw
                # elpd units so they fold into the standard sums (scale_value
                # is one of {1, -1, -2}: the division is exact)
                adj = _chunks.generate(jacobian_fn, idx, (shards.rows,), dtype, "jacobian_fn")
                adj = adj / scale_value
            carry = carries[j]
            if mixture:
                return lambda: _accumulate.mixture_chunk(ll, valid, carry, adj)
            return lambda: _accumulate.accumulate_chunk(ll, valid, carry, adj, method=method,
                                                        tail_max=tail_max)

        for j, (carries[j], elpd_i, diag) in enumerate(shards.decided(work)):
            if pointwise:
                with shards.scope(j):
                    bufs_e[j][shards.part(c)] = elpd_i
                    bufs_d[j][shards.part(c)] = diag.to(dtype)
        if checkpoint_path is not None and (c + 1) % checkpoint_every == 0:
            _save(checkpoint_path, geometry, c + 1, carries, shards, bufs_e, bufs_d)
        if on_chunk is not None:
            on_chunk(c + 1, n_chunks)
    out = _accumulate.combine_carries(carries)
    if checkpoint_path is not None:
        with contextlib.suppress(OSError):
            os.remove(checkpoint_path)
    elpd_i_host = diag_host = None
    if pointwise:
        elpd_i_host = shards.host(bufs_e)
        diag_host = shards.host(bufs_d)

    if mixture:
        # elpd_i = log_norm - log_obs_i, so the sums close in terms of the
        # accumulated sum_lo / sum_lo2 and the final normalizer
        log_norm = out["log_norm"]
        sum_lo = out["sum_lo"]
        sum_e = n_obs * log_norm - sum_lo
        sum_e2 = n_obs * log_norm**2 - 2.0 * log_norm * sum_lo + out["sum_lo2"]
    else:
        sum_e = out["sum_e"]
        sum_e2 = out["sum_e2"]
    lppd = out["sum_lppd"]
    var_e = max(sum_e2 / n_obs - (sum_e / n_obs) ** 2, 0.0)

    warn_mg = False
    n_degenerate = int(out.get("n_degen", 0))
    if n_degenerate:
        warnings.warn(
            f"The float32 fast path left {n_degenerate} observations"
            " unsmoothed because their generalized Pareto fit was degenerate"
            " (sigma <= 0). Recompute with dtype=float64 for reference-exact"
            " handling of these observations.",
            UserWarning,
            stacklevel=2,
        )
    if mixture:
        pass  # no importance weights were formed, so no IS diagnostics
    elif method == ISMethod.PSIS:
        if out["n_bad"] > 0:
            warnings.warn(
                "Estimated shape parameter of Pareto distribution is greater"
                f" than {good_k:.2f} for {out['n_bad']} observations."
                " This indicates that importance sampling may be unreliable"
                " because the marginal posterior and LOO posterior are very"
                " different.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True
    else:
        min_ess = out["diag_min"]
        if min_ess < n_draws * 0.1:
            warnings.warn(
                f"Low effective sample size detected (minimum ESS:"
                f" {min_ess:.1f}). This indicates that the importance sampling"
                " approximation may be unreliable. Consider using PSIS which"
                " is more robust to such cases.",
                UserWarning,
                stacklevel=2,
            )
            warn_mg = True

    loo_lppd = scale_value * sum_e
    loo_lppd_se = abs(scale_value) * float((n_obs * var_e) ** 0.5)
    p_loo = lppd - loo_lppd / scale_value
    # as loo(): sqrt of the population variance of the *scaled* loo_i
    p_loo_se = abs(scale_value) * float(np.sqrt(var_e))
    looic = -2 * loo_lppd
    looic_se = 2 * loo_lppd_se

    loo_lppd_i = diagnostic = None
    if pointwise:
        if mixture:
            # the buffers hold log_obs_i (the normalizer closes only after
            # the full pass); diag_host is already all zeros
            elpd_i_host = log_norm - elpd_i_host
        loo_lppd_i = DataArray(scale_value * elpd_i_host, ("obs",), name="loo_i")
        diagnostic = DataArray(
            diag_host,
            ("obs",),
            name="pareto_k" if mixture or method == ISMethod.PSIS else "ess",
        )

    result = _assemble(
        mixture, loo_lppd, loo_lppd_se, p_loo, p_loo_se, n_draws, n_obs,
        warn_mg, scale, looic, looic_se,
        loo_lppd_i=loo_lppd_i, diagnostic=diagnostic,
        method=method,
        good_k=good_k if mixture or method == ISMethod.PSIS else None,
    )
    result.fast_path_degenerate = n_degenerate
    if mixture and jacobian_fn is not None:
        # parity with loo(): its jacobian block re-derives these rows
        # unconditionally, appending them to the mixture layout in this order
        result["p_loo"] = p_loo
        result["p_loo_se"] = p_loo_se
        result["looic"] = looic
        result["looic_se"] = looic_se
    return result
