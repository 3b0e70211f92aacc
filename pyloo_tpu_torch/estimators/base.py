"""Shared estimator types and subsample index drawing (as ``pyloo_tpu/estimators/base.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Protocol, runtime_checkable

import numpy as np

__all__ = ["BaseEstimate", "SubsampleIndices", "subsample_indices", "compare_indices"]


@dataclass
class BaseEstimate:
    """A population estimate with its two variance components.

    ``y_hat`` is the point estimate of the population total, ``v_y_hat`` the
    variance due to subsampling only, ``hat_v_y`` the total variance
    (approximation + sampling), ``m`` the sample size and ``N`` the
    population size.
    """

    y_hat: float
    v_y_hat: float
    hat_v_y: float
    m: int
    subsampling_SE: float
    N: int = 0


@dataclass
class SubsampleIndices:
    """Sampled observation indices with per-index selection counts."""

    idx: np.ndarray
    m_i: np.ndarray


def subsample_indices(
    estimator: str,
    elpd_loo_approximation: np.ndarray,
    observations: int,
    rng: np.random.Generator | None = None,
) -> SubsampleIndices:
    """Draw a subsample of observation indices for the given estimator.

    hh_pps draws with replacement, probability proportional to
    ``|elpd_approx|``, returning deduplicated indices with counts;
    diff_srs/srs draw a sorted without-replacement sample.

    Unlike the reference (which consumes the global ``np.random`` state,
    ``estimators/base.py:104,117``), an explicit ``rng`` may be passed for
    reproducibility; the default preserves reference behavior.
    """
    n = len(elpd_loo_approximation)
    choice = rng.choice if rng is not None else np.random.choice

    if estimator == "hh_pps":
        pi_values = np.abs(elpd_loo_approximation)
        pi_values = pi_values / pi_values.sum()
        idx = choice(n, size=observations, replace=True, p=pi_values)
        unique_idx, counts = np.unique(idx, return_counts=True)
        return SubsampleIndices(idx=unique_idx, m_i=counts)

    if estimator in ("diff_srs", "srs"):
        if observations > n:
            raise ValueError(
                "Number of observations cannot exceed total sample size "
                "when using SRS without replacement"
            )
        idx = np.sort(choice(n, size=observations, replace=False))
        return SubsampleIndices(idx=idx, m_i=np.ones_like(idx))

    raise ValueError(f"Unknown estimator: {estimator}")


def compare_indices(
    new_indices: SubsampleIndices, current_indices: SubsampleIndices
) -> Dict[str, SubsampleIndices]:
    """Diff two index sets into 'new' / 'add' (shared) / 'remove' groups.

    Powers incremental ``update_subsample`` workflows.
    """
    result: Dict[str, SubsampleIndices] = {}

    new_mask = ~np.isin(new_indices.idx, current_indices.idx)
    if new_mask.any():
        result["new"] = SubsampleIndices(
            idx=new_indices.idx[new_mask], m_i=new_indices.m_i[new_mask]
        )
    add_mask = ~new_mask
    if add_mask.any():
        result["add"] = SubsampleIndices(
            idx=new_indices.idx[add_mask], m_i=new_indices.m_i[add_mask]
        )
    remove_mask = ~np.isin(current_indices.idx, new_indices.idx)
    if remove_mask.any():
        result["remove"] = SubsampleIndices(
            idx=current_indices.idx[remove_mask],
            m_i=current_indices.m_i[remove_mask],
        )
    return result


@runtime_checkable
class EstimatorProtocol(Protocol):
    """Runtime-checkable estimator interface (reference
    ``estimators/base.py:56-72``): anything with an ``estimate`` method
    producing a :class:`BaseEstimate`."""

    def estimate(self, *args, **kwargs) -> "BaseEstimate":  # pragma: no cover
        ...


class DiffEstimate(BaseEstimate):
    """Difference-estimator result (reference ``estimators/difference.py:12``)."""


class HHEstimate(BaseEstimate):
    """Hansen-Hurwitz result (reference ``estimators/hansen_hurwitz.py:12``)."""


class SRSEstimate(BaseEstimate):
    """Simple-random-sampling result (reference ``estimators/srs.py:12``)."""
