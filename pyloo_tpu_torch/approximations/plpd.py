"""Point log predictive density (PLPD) approximation.

``log p(y_i | E[theta])``: evaluate the likelihood at the posterior mean.
With an explicit ``log_likelihood_fn`` and ``data`` the point estimate is
used directly, one host call per observation as in ``pyloo_tpu``; otherwise
the approximation falls back to the mean over draws of the log-likelihood,
on the device in row chunks, with the reference's warning
(``pyloo/approximations/plpd.py:88-100``).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from ..base import _host, as_sample_matrix
from ..containers import DataArray, Dataset
from ..parallel import apply_rowwise
from .base import thin_draws

__all__ = ["PLPDApproximation"]


class PLPDApproximation:
    """PLPD: likelihood at the posterior point estimate."""

    def __init__(self, posterior=None, log_likelihood_fn=None, data=None):
        self.posterior = posterior
        self.log_likelihood_fn = log_likelihood_fn
        self.data = data

    def compute_approximation(
        self, log_likelihood: DataArray, n_draws: Optional[int] = None
    ) -> np.ndarray:
        if self.posterior is None:
            raise ValueError("No posterior samples provided for PLPD approximation")

        posterior = (
            thin_draws(self.posterior, n_draws)
            if n_draws is not None
            else self.posterior
        )

        # posterior point estimates per variable
        if isinstance(posterior, Dataset):
            point_est = {}
            for var, values in posterior.data_vars.items():
                da = values
                if "chain" in da.dims and "draw" in da.dims:
                    da = da.stack(__sample__=("chain", "draw"))
                if "__sample__" in da.dims:
                    point_est[var] = da.mean("__sample__").values
                else:
                    point_est[var] = np.mean(da.values, axis=0)
        elif isinstance(posterior, DataArray):
            da = posterior
            if "chain" in da.dims and "draw" in da.dims:
                da = da.stack(__sample__=("chain", "draw"))
            point_est = da.mean("__sample__").values
        else:
            point_est = np.mean(np.asarray(posterior), axis=0)

        if self.log_likelihood_fn is not None and self.data is not None:
            n_obs = (
                len(self.data)
                if hasattr(self.data, "__len__")
                else log_likelihood.shape[0]
            )
            plpd = np.zeros(n_obs)
            for i in range(n_obs):
                obs_data = self.data[i : i + 1]
                plpd[i] = self.log_likelihood_fn(obs_data, point_est)
            return plpd

        warnings.warn(
            "Using approximate PLPD calculation. For better accuracy, provide "
            "log likelihood and data to compute log likelihoods directly.",
            UserWarning,
            stacklevel=2,
        )
        matrix, _, _ = as_sample_matrix(log_likelihood)
        (out,) = apply_rowwise(lambda b: (b.mean(dim=1),), matrix)
        return _host(out)
