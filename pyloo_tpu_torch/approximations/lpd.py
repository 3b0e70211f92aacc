"""Log predictive density (LPD) approximation: logmeanexp over draws."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..base import _host, as_sample_matrix
from ..containers import DataArray
from ..ops.lse import logsumexp
from ..parallel import apply_rowwise
from .base import thin_draws

__all__ = ["LPDApproximation"]


class LPDApproximation:
    """LPD: ``logsumexp(ll_i) - log S`` per observation, on the device in row chunks."""

    def compute_approximation(
        self, log_likelihood: DataArray, n_draws: Optional[int] = None
    ) -> np.ndarray:
        if n_draws is not None:
            log_likelihood = thin_draws(log_likelihood, n_draws)
        matrix, S, _ = as_sample_matrix(log_likelihood)
        (out,) = apply_rowwise(lambda b: (logsumexp(b, dim=1, b_inv=S),), matrix)
        return _host(out)
