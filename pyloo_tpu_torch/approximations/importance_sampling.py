"""TIS/SIS-based elpd approximations: full IS-LOO with cheaper weighting."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..base import ISMethod, _host, as_sample_matrix
from ..containers import DataArray
from ..ops.loo_kernels import loo_scores_sis, loo_scores_tis
from ..parallel import apply_rowwise
from .base import thin_draws

__all__ = ["ImportanceSamplingApproximation", "TISApproximation", "SISApproximation"]


class ImportanceSamplingApproximation:
    """IS-LOO elpd with the chosen (cheap) weighting method."""

    def __init__(self, method: ISMethod):
        self.method = method

    def compute_approximation(
        self, log_likelihood: DataArray, n_draws: Optional[int] = None
    ) -> np.ndarray:
        if n_draws is not None:
            log_likelihood = thin_draws(log_likelihood, n_draws)
        matrix, _, _ = as_sample_matrix(log_likelihood)
        kernel = loo_scores_sis if self.method == ISMethod.SIS else loo_scores_tis
        elpd_i, _, _ = apply_rowwise(kernel, matrix)
        return _host(elpd_i)


class TISApproximation(ImportanceSamplingApproximation):
    def __init__(self):
        super().__init__(method=ISMethod.TIS)


class SISApproximation(ImportanceSamplingApproximation):
    def __init__(self):
        super().__init__(method=ISMethod.SIS)
