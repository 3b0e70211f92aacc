"""Population-elpd estimators for subsampled LOO (Magnusson et al. 2019/2020).

Capability-equivalent to reference ``pyloo/estimators/*``: the difference
estimator (SRS-WOR with an auxiliary approximation), plain SRS, and the
weighted Hansen-Hurwitz PPS estimator, plus the index-drawing helpers.

A copy of ``pyloo_tpu/estimators/``: numpy only, on the host, so the port
keeps its own rather than importing the JAX package.  The same seed draws
the same rows in both packages.
"""

from .base import (
    BaseEstimate,
    DiffEstimate,
    EstimatorProtocol,
    HHEstimate,
    SRSEstimate,
    SubsampleIndices,
    compare_indices,
    subsample_indices,
)
from .difference import DifferenceEstimator, diff_srs_estimate
from .hansen_hurwitz import (
    HansenHurwitzEstimator,
    compute_sampling_probabilities,
    hansen_hurwitz_estimate,
)
from .hansen_hurwitz import estimate_elpd_loo as hh_estimate_elpd_loo
from .srs import SimpleRandomSamplingEstimator, srs_estimate
from .srs import estimate_elpd_loo as srs_estimate_elpd_loo

ESTIMATOR_REGISTRY = {
    "diff_srs": DifferenceEstimator,
    "hh_pps": HansenHurwitzEstimator,
    "srs": SimpleRandomSamplingEstimator,
}


def get_estimator(method: str):
    """Instantiate an estimator by name ('diff_srs', 'hh_pps', 'srs')."""
    try:
        return ESTIMATOR_REGISTRY[method]()
    except KeyError:
        raise ValueError(
            f"Unknown estimator '{method}'. Must be one of: "
            f"{', '.join(sorted(ESTIMATOR_REGISTRY))}"
        )


__all__ = [
    "BaseEstimate",
    "EstimatorProtocol",
    "DiffEstimate",
    "HHEstimate",
    "SRSEstimate",
    "hh_estimate_elpd_loo",
    "srs_estimate_elpd_loo",
    "SubsampleIndices",
    "subsample_indices",
    "compare_indices",
    "DifferenceEstimator",
    "diff_srs_estimate",
    "SimpleRandomSamplingEstimator",
    "srs_estimate",
    "HansenHurwitzEstimator",
    "hansen_hurwitz_estimate",
    "compute_sampling_probabilities",
    "ESTIMATOR_REGISTRY",
    "get_estimator",
]
