"""Importance-sampling methods and the sample matrix on the device.

Counterpart of ``ISMethod`` and ``as_sample_matrix`` in ``pyloo_tpu/base.py``:
all observation dims flatten into one batch axis of an ``(n_obs, S)`` tensor
on the configured device, which the scorers take in byte-budgeted chunks.
"""

from __future__ import annotations

from enum import Enum

import numpy as np
import torch

from ._common import compute_device
from .containers import DataArray
from .rcparams import rcParams

__all__ = ["ISMethod", "as_sample_matrix"]


class ISMethod(str, Enum):
    """Supported importance sampling methods."""

    PSIS = "psis"
    SIS = "sis"
    TIS = "tis"


def _compute_dtype() -> torch.dtype:
    return torch.float64 if rcParams["device.precision"] == "float64" else torch.float32


def as_sample_matrix(log_weights) -> torch.Tensor:
    """``(n_obs_flat, S)`` tensor of the configured dtype on the configured device.

    Accepts a :class:`DataArray` (``__sample__`` dim anywhere, or unstacked
    ``chain``/``draw`` dims) or an array whose *last* axis is samples.  A
    lazily stacked :class:`DataArray` (the canonical ``(chain, draw, obs)``
    layout) is copied to the device as its contiguous payload and swapped to
    obs-major there, with ``permute(...).contiguous()`` at device-memory
    bandwidth; the host never makes the strided transpose copy.
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
        S = da.sizes["__sample__"]

        lazy = da._lazy
        if lazy is not None and da.dims == target and lazy[0].flags.c_contiguous:
            base, order, n_collapse = lazy
            v = torch.from_numpy(base).to(device).permute(order)
            lead = int(np.prod(v.shape[: v.dim() - n_collapse]))
            return v.reshape(max(lead, 1), -1).to(dtype).contiguous()
        if da.dims != target:
            da = da.transpose(*target)
        values = da.values.reshape(-1, S) if obs_dims else da.values.reshape(1, S)
        return torch.from_numpy(np.ascontiguousarray(values)).to(device, dtype)

    arr = np.asarray(log_weights)
    if arr.ndim == 0:
        raise ValueError("log_weights must have at least one dimension")
    S = arr.shape[-1]
    return torch.from_numpy(np.ascontiguousarray(arr.reshape(-1, S))).to(device, dtype)
