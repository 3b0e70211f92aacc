"""Importance-sampling methods, the sample matrix on the device, the weights.

Counterpart of ``pyloo_tpu/base.py``: all observation dims flatten into one
batch axis of an ``(n_obs, S)`` tensor on the configured device, which the
scorers take in byte-budgeted chunks; :func:`compute_importance_weights`
hands the weights back in the caller's container and shape, on the host.
"""

from __future__ import annotations

from enum import Enum
from typing import Union

import numpy as np
import torch

from ._common import compute_device
from ._staging import to_device
from .containers import DataArray
from .ops import psislw_batch, sislw_batch, tail_length, tislw_batch
from .parallel import apply_rowwise
from .profiling import count
from .rcparams import rcParams

__all__ = ["ISMethod", "as_sample_matrix", "compute_importance_weights", "importance_weights"]

# full-width (chunk, S) buffers the weight functions hold beyond the scorers'
# four: the weights they return and the selection's indices
_WEIGHTS_EXTRA_BUFFERS = 2


class ISMethod(str, Enum):
    """Supported importance sampling methods."""

    PSIS = "psis"
    SIS = "sis"
    TIS = "tis"


def _compute_dtype() -> torch.dtype:
    return torch.float64 if rcParams["device.precision"] == "float64" else torch.float32


def _host(t: torch.Tensor) -> np.ndarray:
    count("host_reads", "base._host")
    return t.cpu().numpy()


def as_sample_matrix(log_weights):
    """``(matrix, S, rebuild)``: the ``(n_obs_flat, S)`` tensor, S, and the way back.

    The tensor has the configured dtype and lies on the configured device.

    Accepts a :class:`DataArray` (``__sample__`` dim anywhere, or unstacked
    ``chain``/``draw`` dims) or an array whose *last* axis is samples.  A
    lazily stacked :class:`DataArray` (the canonical ``(chain, draw, obs)``
    layout) is copied to the device as its contiguous payload and swapped to
    obs-major there, with ``permute(...).contiguous()`` at device-memory
    bandwidth; the host never makes the strided transpose copy.  A large host
    payload bound for a CUDA device goes through a ring of pinned buffers
    filled by several host threads (:func:`._staging.to_device`), with the
    same result bit for bit.

    On the CPU the tensor may share memory with the caller's array: nothing
    writes into it.

    ``rebuild(lw2d, diag1d)`` restores the caller's container and shape from
    host arrays: ``(lw, diag)`` as :class:`DataArray` for a
    :class:`DataArray`, as ndarrays otherwise (``lw`` is ``None`` when
    ``lw2d`` is).
    """
    dtype = _compute_dtype()
    device = compute_device()

    if isinstance(log_weights, DataArray):
        da = log_weights
        if "__sample__" not in da.dims:
            if "chain" in da.dims and "draw" in da.dims:
                da = da.stack(__sample__=("chain", "draw"))
            else:
                raise ValueError("log_weights must have a __sample__ dimension")
        obs_dims = tuple(d for d in da.dims if d != "__sample__")
        target = obs_dims + ("__sample__",)
        obs_shape = tuple(da.sizes[d] for d in obs_dims)
        S = da.sizes["__sample__"]
        coords = {d: c for d, c in da.coords.items() if d in obs_dims}
        sample_coord = da.coords.get("__sample__")

        lazy = da._lazy
        if lazy is not None and da.dims == target and lazy[0].flags.c_contiguous:
            base, order, n_collapse = lazy
            count("h2d_bytes", "ingest", base.nbytes)
            v = to_device(torch.from_numpy(base), device).permute(order)
            lead = int(np.prod(v.shape[: v.dim() - n_collapse]))
            matrix = v.reshape(max(lead, 1), -1).to(dtype).contiguous()
        else:
            if da.dims != target:
                da = da.transpose(*target)
            values = da.values.reshape(-1, S) if obs_dims else da.values.reshape(1, S)
            count("h2d_bytes", "ingest", values.nbytes)
            matrix = to_device(torch.from_numpy(np.ascontiguousarray(values)), device, dtype)

        def rebuild_da(lw2d, diag1d):
            lw_da = None
            if lw2d is not None:
                lw_coords = dict(coords)
                if sample_coord is not None:
                    lw_coords["__sample__"] = sample_coord
                lw_da = DataArray(
                    np.asarray(lw2d).reshape(obs_shape + (S,)), target, lw_coords, "log_weights"
                )
            diag_da = DataArray(np.asarray(diag1d).reshape(obs_shape), obs_dims, dict(coords))
            return lw_da, diag_da

        return matrix, S, rebuild_da

    if isinstance(log_weights, torch.Tensor):
        # a tensor goes to the device as a tensor: numpy cannot read one on
        # the card (pyloo_tpu takes a device array the same way)
        if log_weights.dim() == 0:
            raise ValueError("log_weights must have at least one dimension")
        obs_shape = tuple(log_weights.shape[:-1])
        S = log_weights.shape[-1]
        if log_weights.device.type == "cpu":
            count("h2d_bytes", "ingest", log_weights.numel() * log_weights.element_size())
        matrix = to_device(log_weights.detach().reshape(-1, S), device, dtype).contiguous()
    else:
        arr = np.asarray(log_weights)
        if arr.ndim == 0:
            raise ValueError("log_weights must have at least one dimension")
        obs_shape = arr.shape[:-1]
        S = arr.shape[-1]
        count("h2d_bytes", "ingest", arr.nbytes)
        host = torch.from_numpy(np.ascontiguousarray(arr.reshape(-1, S)))
        matrix = to_device(host, device, dtype)

    def rebuild_array(lw2d, diag1d):
        lw = None if lw2d is None else np.asarray(lw2d).reshape(obs_shape + (S,))
        diag = np.asarray(diag1d).reshape(obs_shape)
        if diag.ndim == 0:
            diag = diag[()]
        return lw, diag

    return matrix, S, rebuild_array


def compute_importance_weights(
    log_weights: Union[DataArray, np.ndarray, None] = None,
    method: Union[ISMethod, str] = ISMethod.PSIS,
    reff: float = 1.0,
):
    """Compute smoothed/truncated/normalized log importance weights.

    Parameters
    ----------
    log_weights : DataArray or (..., S) array-like
        Raw log weights; for LOO this is ``-log_likelihood``.
    method : {'psis', 'sis', 'tis'}
    reff : float
        Relative MCMC efficiency (PSIS tail sizing only).

    Returns
    -------
    lw_out
        Processed log weights, same container type/shape as the input.
    diagnostic
        Pareto k (PSIS) or effective sample size (SIS/TIS) per observation.

    The weights are computed on ``rcParams["device.device"]`` in row chunks
    and written into one ``(n_obs, S)`` tensor there, then copied to the
    host.
    """
    if isinstance(method, str):
        try:
            method = ISMethod(method.lower())
        except ValueError:
            valid_methods = ", ".join(m.value for m in ISMethod)
            raise ValueError(
                f"Invalid method '{method}'. Must be one of: {valid_methods}"
            )

    if log_weights is None:
        raise ValueError("log_weights must be provided")

    matrix, _, rebuild = as_sample_matrix(log_weights)
    lw, diag = importance_weights(matrix, method, reff)
    del matrix

    lw_out, diag_out = rebuild(_host(lw), _host(diag))
    if isinstance(diag_out, DataArray):
        diag_out = diag_out.rename("pareto_shape" if method == ISMethod.PSIS else "ess")
    return lw_out, diag_out


def importance_weights(matrix: torch.Tensor, method: ISMethod, reff: float = 1.0):
    """``(lw, diag)`` of an ``(n_obs, S)`` tensor of raw log weights, on its
    device: the smoothed, truncated or normalised log weights and each
    row's Pareto k (PSIS) or effective sample size (SIS, TIS)."""
    n_samples = matrix.shape[1]
    if n_samples < 2:
        raise ValueError(
            "importance sampling requires at least 2 draws per observation,"
            f" got {n_samples}"
        )
    if method == ISMethod.PSIS:
        m_tail = tail_length(n_samples, reff)
        kernel = lambda block: psislw_batch(block, m_tail)  # noqa: E731
    elif method == ISMethod.SIS:
        kernel = sislw_batch
    else:
        kernel = tislw_batch
    return apply_rowwise(kernel, matrix, extra_buffers=_WEIGHTS_EXTRA_BUFFERS)
