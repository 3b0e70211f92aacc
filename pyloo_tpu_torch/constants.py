"""Method namespaces shared across the LOO-CV estimators.

These enumerations define the public string names accepted by
``loo_subsample`` and friends (reference surface: ``pyloo/constants.py``).
A copy of ``pyloo_tpu/constants.py``: the port imports nothing of the JAX
package.
"""

from enum import Enum
from typing import Literal

# output scales accepted everywhere a ``scale`` argument appears
SCALE_OPTIONS = Literal["deviance", "log", "negative_log"]


class LooApproximationMethod(str, Enum):
    """Cheap per-observation elpd approximations driving subsampled LOO.

    ``plpd``
        log likelihood at a posterior point estimate (default; one pass).
    ``lpd``
        full log predictive density (logmeanexp over draws).
    ``tis`` / ``sis``
        truncated / standard importance-sampling LOO with cheaper weights.
    """

    PLPD = "plpd"
    LPD = "lpd"
    TIS = "tis"
    SIS = "sis"


LooApproximationMethodType = Literal["plpd", "lpd", "tis", "sis"]


class EstimatorMethod(str, Enum):
    """Survey estimators of the population elpd from a subsample.

    ``diff_srs``
        difference estimator under simple random sampling without
        replacement (default — exploits the approximation as an auxiliary
        variable).
    ``hh_pps``
        weighted Hansen-Hurwitz estimator, probability proportional to the
        magnitude of the approximation, with replacement.
    ``srs``
        plain simple-random-sampling expansion estimator.
    """

    DIFF_SRS = "diff_srs"
    HH_PPS = "hh_pps"
    SRS = "srs"


EstimatorMethodType = Literal["diff_srs", "hh_pps", "srs"]
