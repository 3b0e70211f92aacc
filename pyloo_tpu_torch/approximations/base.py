"""Approximation interface and draw thinning (numpy, as ``pyloo_tpu/approximations/base.py``)."""

from __future__ import annotations

from typing import Optional, Protocol

import numpy as np

from ..containers import DataArray, Dataset

__all__ = ["LooApproximation", "thin_draws"]


class LooApproximation(Protocol):
    """Anything that maps a stacked log-likelihood to per-obs elpd guesses."""

    def compute_approximation(
        self, log_likelihood: DataArray, n_draws: Optional[int] = None
    ) -> np.ndarray: ...


def thin_draws(data, n_draws: Optional[int] = None):
    """Evenly-spaced thinning of the sample dimension to ``n_draws``.

    Accepts a :class:`DataArray` (with ``__sample__`` or chain/draw dims) or a
    :class:`Dataset`; mirrors reference ``approximations/base.py:37-107``.
    """
    if n_draws is None:
        return data

    if isinstance(data, Dataset):
        return Dataset(
            {k: thin_draws(v, n_draws) for k, v in data.data_vars.items()},
            data.attrs,
        )

    da = data
    if "__sample__" not in da.dims:
        if "chain" in da.dims and "draw" in da.dims:
            da = da.stack(__sample__=("chain", "draw"))
        else:
            raise ValueError("No sample dimension found in DataArray")
    n_samples = da.sizes["__sample__"]
    if n_draws > n_samples:
        raise ValueError(
            f"Target number of draws ({n_draws}) cannot exceed "
            f"current number of draws ({n_samples})"
        )
    idx = np.linspace(0, n_samples - 1, n_draws, dtype=int)
    return da.isel(__sample__=idx)


def compute_point_estimate(posterior):
    """Posterior-mean point estimate per variable.

    The reference exports this name (``approximations/__init__.py:10``) but
    never defines it — ``from pyloo.approximations import *`` raises there.
    Provided here as the working utility the PLPD approximation implies:
    the mean over the sample dimension(s) of each posterior variable.
    Accepts a dict of arrays / DataArrays or a Dataset; returns a dict of
    NumPy arrays with chain/draw (or ``__sample__``) axes averaged out.
    """
    import numpy as np

    def mean_of(v):
        vals = getattr(v, "values", v)
        dims = getattr(v, "dims", None)
        arr = np.asarray(vals)
        if dims is not None:
            axes = tuple(
                i for i, d in enumerate(dims)
                if d in ("chain", "draw", "__sample__", "sample")
            )
            if axes:
                return arr.mean(axis=axes)
        # plain arrays: leading axes are (chain, draw) or (sample,)
        if arr.ndim >= 2:
            return arr.mean(axis=(0, 1)) if arr.ndim > 2 else arr.mean(axis=(0, 1))
        return arr.mean() if arr.ndim else arr

    items = (
        posterior.data_vars.items()
        if hasattr(posterior, "data_vars")
        else posterior.items()
    )
    return {name: mean_of(v) for name, v in items}
