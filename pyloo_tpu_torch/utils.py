"""Host-side substrate: ingestion, log-likelihood extraction, logsumexp.

Counterpart of ``pyloo_tpu/utils.py`` (numpy only): ``from_dict``,
``to_inference_data``, ``get_log_likelihood``, the stable host
``_logsumexp``, ``reshape_draws`` and the reference's per-observation loop
shims ``make_ufunc`` / ``wrap_xarray_ufunc`` (for user code written against
the reference API; the library itself runs batched kernels).
``to_inference_data`` routes file paths and foreign ``InferenceData``
objects to :mod:`pyloo_tpu_torch.ingest`.
"""

from __future__ import annotations

import os
import warnings
from collections.abc import Sequence
from typing import Any, Optional, Tuple

import numpy as np

from .containers import DataArray, Dataset, InferenceData

__all__ = [
    "to_inference_data",
    "get_log_likelihood",
    "from_dict",
    "reshape_draws",
    "_logsumexp",
    "wrap_xarray_ufunc",
    "make_ufunc",
]


def from_dict(
    posterior=None,
    log_likelihood=None,
    sample_stats=None,
    posterior_predictive=None,
    observed_data=None,
    constant_data=None,
    coords=None,
    dims=None,
) -> InferenceData:
    """Build an :class:`InferenceData` from dicts of (chain, draw, ...) arrays.

    ``dims`` maps a variable name to the names of its trailing (non chain/draw)
    dimensions; ``coords`` maps a dimension name to its labels.
    """
    coords = coords or {}
    dims = dims or {}

    def build(group, sample_dims=True):
        if group is None:
            return None
        out = {}
        for name, values in group.items():
            if isinstance(values, DataArray):
                out[name] = values
                continue
            values = np.asarray(values)
            extra = dims.get(name)
            if sample_dims:
                n_extra = values.ndim - 2
                if extra is None:
                    extra = [f"{name}_dim_{i}" for i in range(n_extra)]
                var_dims = ("chain", "draw", *extra)
            else:
                if extra is None:
                    extra = [f"{name}_dim_{i}" for i in range(values.ndim)]
                var_dims = tuple(extra)
            var_coords = {d: coords[d] for d in var_dims if d in coords}
            out[name] = DataArray(values, var_dims, var_coords, name)
        return Dataset(out)

    return InferenceData(
        posterior=build(posterior),
        log_likelihood=build(log_likelihood),
        sample_stats=build(sample_stats),
        posterior_predictive=build(posterior_predictive),
        observed_data=build(observed_data, sample_dims=False),
        constant_data=build(constant_data, sample_dims=False),
    )


def to_inference_data(obj: Any) -> InferenceData:
    """Convert supported objects to :class:`InferenceData`.

    Supported: :class:`InferenceData` (returned as-is), anything exposing a
    ``to_inference_data()`` method that returns one, a netCDF file path
    (``str`` / ``os.PathLike``), a CmdStan CSV path or glob (``*.csv``
    routes to :func:`pyloo_tpu_torch.ingest.from_cmdstan`), a foreign
    arviz-style InferenceData (the duck-typed group / Dataset attribute
    protocol, e.g. the idata of ``pymc.sample``), :class:`Dataset`,
    ``dict`` of array-likes (treated as the posterior group), and bare
    arrays of shape ``(chain, draw, ...)``.
    """
    if isinstance(obj, InferenceData):
        return obj

    if hasattr(obj, "to_inference_data"):
        converted = obj.to_inference_data()
        if isinstance(converted, InferenceData):
            return converted

    if isinstance(obj, (str, os.PathLike)):
        text = os.fspath(obj)
        if text.endswith(".csv") or (any(ch in text for ch in "*?[") and ".csv" in text):
            from .ingest import from_cmdstan

            return from_cmdstan(obj)
        from .ingest import from_netcdf

        return from_netcdf(obj)

    if isinstance(obj, (list, tuple)):
        raise ValueError(
            "Lists and tuples cannot be converted to InferenceData directly"
        )

    if isinstance(obj, Dataset):
        return InferenceData(posterior=obj)

    from .ingest import convert_foreign, looks_like_foreign_idata

    if looks_like_foreign_idata(obj):
        return convert_foreign(obj)

    if isinstance(obj, dict):
        if not all(
            isinstance(v, (np.ndarray, list, DataArray)) or hasattr(v, "__array__")
            for v in obj.values()
        ):
            raise ValueError("Dictionary values must be array-like")
        return from_dict(posterior=obj)

    if hasattr(obj, "__array__"):
        arr = np.asarray(obj)
        if arr.ndim < 2:
            arr = arr.reshape((1,) * (2 - arr.ndim) + arr.shape)
        return from_dict(posterior={"x": arr})

    raise ValueError(
        "Can only convert InferenceData, Dataset, dict with array-like values, "
        f"or numpy array to InferenceData, not {type(obj).__name__}"
    )


def get_log_likelihood(idata: InferenceData, var_name=None, single_var=True):
    """Retrieve the pointwise log-likelihood DataArray from an InferenceData.

    Matches the reference semantics (``pyloo/utils.py:257-302``), including the
    deprecated ``sample_stats.log_likelihood`` fallback.
    """
    if (
        not hasattr(idata, "log_likelihood")
        and hasattr(idata, "sample_stats")
        and hasattr(idata.sample_stats, "log_likelihood")
    ):
        warnings.warn(
            "Storing the log_likelihood in sample_stats groups has been deprecated",
            DeprecationWarning,
            stacklevel=2,
        )
        return idata.sample_stats.log_likelihood
    if not hasattr(idata, "log_likelihood"):
        raise TypeError("log likelihood not found in inference data object")
    if var_name is None:
        var_names = list(idata.log_likelihood.data_vars)
        if len(var_names) > 1:
            if single_var:
                raise TypeError(
                    f"Found several log likelihood arrays {var_names}, var_name "
                    "cannot be None"
                )
            return idata.log_likelihood[var_names]
        return idata.log_likelihood[var_names[0]]
    try:
        return idata.log_likelihood[var_name]
    except KeyError as err:
        raise TypeError(f"No log likelihood data named {var_name} found") from err


def reshape_draws(
    x: np.ndarray, chain_ids: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Reshape MCMC draws between (iter, chain, param) and matrix formats."""
    if x.ndim == 3:
        return x.reshape(-1, x.shape[2]), None
    if x.ndim == 2 and chain_ids is not None:
        n_chains = len(np.unique(chain_ids))
        n_iter = len(x) // n_chains
        return x.reshape(n_iter, n_chains, -1), chain_ids
    return x, chain_ids


def _logsumexp(ary, *, b=None, b_inv=None, axis=None, keepdims=False):
    """Numerically stable host logsumexp with optional scalar scaling.

    ``log(sum(b * exp(ary)))`` along ``axis``; ``b_inv`` is shorthand for
    ``b = 1/b_inv`` and takes precedence.  Mirrors the numeric semantics of the
    reference implementation (``pyloo/utils.py:305-359``): integer input is
    promoted to float64, ``b_inv == 0`` yields ``+inf`` and ``b == 0`` yields
    ``-inf``.
    """
    ary = np.asarray(ary)
    if np.issubdtype(ary.dtype, np.integer):
        ary = ary.astype(np.float64)

    if b_inv == 0:
        shape = _reduced_shape(ary.shape, axis, keepdims)
        out = np.full(shape, np.inf, dtype=ary.dtype)
        return out if out.shape else ary.dtype.type(np.inf)
    if b_inv is None and b == 0:
        shape = _reduced_shape(ary.shape, axis, keepdims)
        out = np.full(shape, -np.inf, dtype=ary.dtype)
        return out if out.shape else ary.dtype.type(-np.inf)

    ary_max = ary.max(axis=axis, keepdims=True)
    shifted = np.exp(ary - ary_max)
    summed = shifted.sum(axis=axis, keepdims=keepdims)
    out = np.log(summed)
    if b_inv is not None:
        ary_max = ary_max - np.log(b_inv)
    elif b:
        ary_max = ary_max + np.log(b)
    out = out + (ary_max if keepdims else ary_max.squeeze(axis=_norm_axis(axis, ary.ndim)))
    if out.ndim == 0:
        return ary.dtype.type(out)
    return out


def _norm_axis(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, Sequence):
        return tuple(a if a >= 0 else ndim + a for a in axis)
    return (axis if axis >= 0 else ndim + axis,)


def _reduced_shape(shape, axis, keepdims):
    axes = _norm_axis(axis, len(shape))
    if keepdims:
        return tuple(1 if i in axes else d for i, d in enumerate(shape))
    return tuple(d for i, d in enumerate(shape) if i not in axes)


def make_ufunc(func, n_dims=1, n_output=1, n_input=1, ravel=True):
    """Lift a 1-D function to loop over leading observation dimensions.

    Compatibility shim for user code written against the reference API
    (``pyloo/utils.py:82-183``); numpy on the host, one call a row.
    """

    def _ufunc(*args, **kwargs):
        arys = args[:n_input]
        lead = arys[-1].shape[:-n_dims]
        outs = None
        for idx in np.ndindex(lead):
            rows = [a[idx].ravel() if ravel else a[idx] for a in arys]
            res = func(*rows, *args[n_input:], **kwargs)
            if n_output == 1:
                res = (res,)
            if outs is None:
                outs = []
                for r in res:
                    r = np.asarray(r)
                    outs.append(np.empty(lead + r.shape, dtype=r.dtype))
            for o, r in zip(outs, res):
                o[idx] = r
        if outs is None:
            outs = [np.empty(lead) for _ in range(n_output)]
        return outs[0] if n_output == 1 else tuple(outs)

    return _ufunc


def wrap_xarray_ufunc(
    ufunc,
    *datasets,
    ufunc_kwargs=None,
    func_args=None,
    func_kwargs=None,
    input_core_dims=None,
    output_core_dims=None,
):
    """Apply a 1-D function across observations of labeled arrays.

    Compatibility shim over :func:`make_ufunc` for :class:`DataArray` inputs
    whose sample dimension is the trailing core dim (reference
    ``pyloo/utils.py:186-240``).
    """
    ufunc_kwargs = dict(ufunc_kwargs or {})
    func_args = func_args or ()
    func_kwargs = dict(func_kwargs or {})
    func_kwargs.pop("out", None)
    n_output = ufunc_kwargs.get("n_output", 1)
    ufunc_kwargs.setdefault("n_input", len(datasets))

    arrays = []
    template = None
    for d in datasets:
        if isinstance(d, DataArray):
            template = d
            arrays.append(d.values)
        else:
            arrays.append(np.asarray(d))

    looped = make_ufunc(
        ufunc,
        n_dims=ufunc_kwargs.get("n_dims", 1),
        n_output=n_output,
        n_input=ufunc_kwargs["n_input"],
        ravel=ufunc_kwargs.get("ravel", True),
    )
    result = looped(*arrays, *func_args, **func_kwargs)
    if n_output == 1:
        result = (result,)

    wrapped = []
    out_dims = output_core_dims or [[] for _ in range(n_output)]
    core_in = (input_core_dims or [["__sample__"]])[0]
    for res, core in zip(result, out_dims):
        if template is not None:
            dims = tuple(d for d in template.dims if d not in core_in) + tuple(core)
            coords = {d: template.coords[d] for d in dims if d in template.coords}
            wrapped.append(DataArray(res, dims, coords))
        else:
            wrapped.append(res)
    return wrapped[0] if n_output == 1 else tuple(wrapped)
