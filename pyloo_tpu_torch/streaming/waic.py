"""Streaming WAIC: the log-likelihood made on the device chunk by chunk.

Counterpart of ``waic_streaming`` and ``_waic_chunk`` in
``pyloo_tpu/streaming.py``: each chunk's pointwise lppd and variance come
from :func:`pyloo_tpu_torch.ops.loo_kernels.waic_scores`, and the running
sums stay on the device in float64 until one host read at the end.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .._common import compute_device, resolve_scale
from ..containers import DataArray
from ..elpd import ELPDData
from ..ops.loo_kernels import waic_scores
from ..parallel.sharding import as_mesh
from . import _chunks
from .loo import _as_dtype

__all__ = ["waic_streaming"]

_ACC = torch.float64


def waic_streaming(
    log_lik_fn,
    n_obs: int,
    n_draws: int,
    *,
    chunk_size: int | None = None,
    pointwise: bool = False,
    scale: str | None = None,
    dtype=None,
    mesh=None,
    on_chunk=None,
):
    """WAIC (:func:`pyloo_tpu_torch.waic`) over ``n_obs`` observations whose
    log-likelihood is computed on the device by ``log_lik_fn``; the
    ``(n_obs, n_draws)`` matrix is never built.

    Same generator contract as :func:`pyloo_tpu_torch.loo_streaming` (a
    disk chunk source included); same
    result rows as :func:`pyloo_tpu_torch.waic` (reference
    ``pyloo/waic.py:16-207``).  Over a ``mesh`` each device sums its own
    shards' rows; the sums are added on the host at the end.
    """
    scale, scale_value = resolve_scale(scale)
    if n_draws < 2:
        raise ValueError("WAIC requires at least 2 draws per observation.")
    if n_obs < 1:
        raise ValueError("n_obs must be positive.")
    mesh = as_mesh(mesh, "waic_streaming")
    device = compute_device()
    dtype = _as_dtype(dtype)
    chunk_size, n_chunks = _chunks.resolve_chunk(chunk_size, n_obs, n_draws, dtype, mesh=mesh)
    shards = _chunks.Shards(mesh, chunk_size, n_chunks, n_obs, device)

    # sum of the unscaled pointwise WAIC, its square, p_waic, and the count
    # of rows whose variance exceeds 0.4 (reference pyloo/waic.py:137-154),
    # one vector a shard
    sums = [torch.zeros(4, dtype=_ACC, device=d) for d in shards.devices]
    bufs_w = shards.buffers(dtype) if pointwise else None
    make = _chunks.chunk_maker(log_lik_fn, chunk_size, n_obs, n_draws, dtype, shards.devices,
                               "log_lik_fn")
    for c in range(n_chunks):
        for j, _ in shards:
            with shards.scope(j):
                idx, valid = shards.indices(c, j)
                ll = make(c, j, idx)
                lppd_i, vars_lpd = waic_scores(ll)
                del ll
                waic_u = lppd_i - vars_lpd  # the scale is applied on the host at the end
                w = torch.where(valid, waic_u, 0.0).to(_ACC)
                sums[j] += torch.stack([
                    w.sum(), (w * w).sum(), torch.where(valid, vars_lpd, 0.0).to(_ACC).sum(),
                    ((vars_lpd > 0.4) & valid).sum().to(_ACC),
                ])
                if pointwise:
                    bufs_w[j][shards.part(c)] = waic_u
        if on_chunk is not None:
            on_chunk(c + 1, n_chunks)

    per_shard = [v.tolist() for v in sums]
    sum_w, sum_w2, p_waic, n_high_var = (
        sum(col[1:], col[0]) for col in zip(*per_shard)
    )
    var_w = max(sum_w2 / n_obs - (sum_w / n_obs) ** 2, 0.0)

    warn_mg = int(n_high_var) > 0
    if warn_mg:
        warnings.warn(
            "For one or more samples the posterior variance of the log"
            " predictive densities exceeds 0.4. This could be indication of"
            " WAIC starting to fail.",
            UserWarning,
            stacklevel=2,
        )

    waic_sum = scale_value * sum_w
    waic_se = abs(scale_value) * float((n_obs * var_w) ** 0.5)

    rows = [
        ("elpd_waic", waic_sum),
        ("se", waic_se),
        ("p_waic", p_waic),
        ("n_samples", n_draws),
        ("n_data_points", n_obs),
        ("warning", warn_mg),
    ]
    if pointwise:
        waic_i = scale_value * shards.host(bufs_w).astype(np.float64)
        if np.allclose(waic_i, waic_i.flat[0]):
            warnings.warn(
                "The point-wise WAIC is the same with the sum WAIC, please"
                " double check the Observed RV in your model to make sure it"
                " returns element-wise logp.",
                UserWarning,
                stacklevel=2,
            )
        rows.append(("waic_i", DataArray(waic_i, ("obs",), name="waic_i")))
    rows.append(("scale", scale))
    return ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
