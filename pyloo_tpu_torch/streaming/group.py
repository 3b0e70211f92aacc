"""Streaming leave-one-group-out cross-validation.

Counterpart of ``loo_group_streaming`` and ``_logo_chunk`` in
``pyloo_tpu/streaming.py``: each chunk of the per-observation log-likelihood
is made on the device (or read from disk) and added with ``index_add_`` into
an ``(n_groups + 1, n_draws)`` float64 matrix of group sums, whose extra row
takes the padded rows of a ragged last chunk; the ``(n_obs, n_draws)``
matrix never exists.  The group-level IS step and the result are
:func:`pyloo_tpu_torch.loo_group`'s.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .._common import compute_device, resolve_scale
from ..base import ISMethod
from ..loo_group import _logo_result
from ..parallel.sharding import as_mesh
from . import _chunks
from .loo import _as_dtype

__all__ = ["loo_group_streaming"]

# the group sums are float64, as pyloo_tpu's under its import-time x64
_ACC = torch.float64


def loo_group_streaming(
    log_lik_fn,
    group_ids,
    n_obs: int,
    n_draws: int,
    *,
    reff: float = 1.0,
    pointwise: bool = False,
    scale: str | None = None,
    method="psis",
    chunk_size: int | None = None,
    dtype=None,
    mesh=None,
    on_chunk=None,
):
    """Leave-one-group-out CV (:func:`pyloo_tpu_torch.loo_group`) where the
    per-observation log-likelihood is made chunk by chunk and added into the
    ``(n_groups, n_draws)`` group matrix on the device.

    ``log_lik_fn`` follows the contract of
    :func:`pyloo_tpu_torch.loo_streaming` (a disk chunk source included);
    ``group_ids`` is the length-``n_obs`` host vector of group labels.  The
    group sums are float64 whatever ``dtype``, so the group scorer is the
    exact float64 one.  Over a ``mesh`` each device adds its shards' rows
    into a group matrix of its own, and the matrices are added on the host
    in device order: a group whose rows lie on several devices is summed in
    another order than with no mesh.
    """
    scale, scale_value = resolve_scale(scale)
    if n_draws < 2:
        raise ValueError("LOGO requires at least 2 draws per observation.")
    if n_obs < 1:
        raise ValueError("n_obs must be positive.")
    group_ids = np.asarray(group_ids).ravel()
    if len(group_ids) != n_obs:
        raise ValueError(
            f"Length of group_ids ({len(group_ids)}) must match the number"
            f" of observations ({n_obs})."
        )
    unique_groups, group_index = np.unique(group_ids, return_inverse=True)
    n_groups = len(unique_groups)

    try:
        method = method if isinstance(method, ISMethod) else ISMethod(method.lower())
    except ValueError:
        valid_methods = ", ".join(m.value for m in ISMethod)
        raise ValueError(f"Invalid method '{method}'. Must be one of: {valid_methods}")
    if method != ISMethod.PSIS:
        warnings.warn(
            f"Using {method.value.upper()} for LOGO computation. Note that"
            " PSIS is the recommended method as it is typically more"
            " efficient and reliable.",
            UserWarning,
            stacklevel=2,
        )
    mesh = as_mesh(mesh, "loo_group_streaming")

    device = compute_device()
    dtype = _as_dtype(dtype)
    chunk_size, n_chunks = _chunks.resolve_chunk(chunk_size, n_obs, n_draws, dtype, mesh=mesh)
    shards = _chunks.Shards(mesh, chunk_size, n_chunks, n_obs, device)
    make = _chunks.chunk_maker(log_lik_fn, chunk_size, n_obs, n_draws, dtype, shards.devices,
                               "log_lik_fn")

    # segment ids, padded with the overflow group for the ragged tail
    seg_host = np.full(n_chunks * chunk_size, n_groups, np.int64)
    seg_host[:n_obs] = group_index.reshape(-1)
    segs = shards.split(seg_host, torch.int64)

    sums = [torch.zeros((n_groups + 1, n_draws), dtype=_ACC, device=d) for d in shards.devices]
    for c in range(n_chunks):
        for j, _ in shards:
            with shards.scope(j):
                idx, _ = shards.indices(c, j)
                sums[j].index_add_(0, segs[j][shards.part(c)], make(c, j, idx).to(_ACC))
        if on_chunk is not None:
            on_chunk(c + 1, n_chunks)
    total = sums[0]
    if len(sums) > 1:  # the devices' group matrices meet on the host
        total = sums[0].cpu()
        for part in sums[1:]:
            total += part.cpu()
        total = total.to(device)

    return _logo_result(
        total[:n_groups], unique_groups, n_draws, reff, scale, scale_value, method, pointwise,
    )
