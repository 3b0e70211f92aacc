"""Cheap elpd approximations that drive the subsampling estimators.

Each approximation maps the full ``(N, S)`` log-likelihood to an N-vector of
per-observation elpd guesses in one pass over row chunks on the device — the
auxiliary variable that makes the difference and PPS estimators efficient
(counterpart of ``pyloo_tpu/approximations/``, reference
``pyloo/approximations/``).

Registry:

========  ==============================  =====================
name      class                            cost per observation
========  ==============================  =====================
plpd      :class:`PLPDApproximation`       one likelihood eval
lpd       :class:`LPDApproximation`        one logmeanexp
tis       :class:`TISApproximation`        truncated IS-LOO
sis       :class:`SISApproximation`        standard IS-LOO
========  ==============================  =====================
"""

from .base import compute_point_estimate, LooApproximation, thin_draws
from .lpd import LPDApproximation
from .plpd import PLPDApproximation
from .importance_sampling import (
    ImportanceSamplingApproximation,
    SISApproximation,
    TISApproximation,
)

__all__ = [
    "LooApproximation",
    "compute_point_estimate",
    "PLPDApproximation",
    "LPDApproximation",
    "TISApproximation",
    "SISApproximation",
    "ImportanceSamplingApproximation",
    "thin_draws",
]
