"""LOO-CRPS / LOO-SCRPS (Bolin & Wallin 2023).

Counterpart of ``pyloo_tpu/loo_score.py`` (reference
``pyloo/loo_score.py:48-532``): ``crps = 0.5*E|X-X'| - E|X-y|`` (or the
scaled variant) under leave-one-out importance weights, with ``E|X-X'|``
under the joint two-sample LOO weights over shuffled draw pairings.

``pyloo_tpu`` runs ``psislw`` and ``e_loo`` once for ``E|X-y|`` and once a
permutation, each a round trip of the ``(n_obs, S)`` weights through the
host.  Here ``ll``, ``x`` and ``x2`` go to the device once and each row
chunk is scored there by one function, :func:`_crps_chunk`, which
:func:`pyloo_tpu_torch.loo_score_streaming` shares: no weights leave the
device, and Pareto k comes from the first smoothing.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from ._common import _any_rowblock, compute_reff, good_k_threshold
from .base import _host, as_sample_matrix
from .containers import DataArray, InferenceData
from .ops import psislw_batch, tail_length
from .ops.expectations import weighted_expectation_batch
from .parallel import apply_rowwise
from .rcparams import rcParams
from .utils import get_log_likelihood, to_inference_data

__all__ = ["loo_score", "crps", "scrps", "LooScoreResult"]

# full-width (chunk, S) buffers of _crps_chunk beyond the scorers' four: x,
# x2, the negated log-likelihood, a permuted column gather, |x - .| and the
# weights of the pass in flight
_SCORE_EXTRA_BUFFERS = 6


@dataclass
class LooScoreResult:
    """CRPS/SCRPS estimates: named (Estimate, SE) record + pointwise values."""

    estimates: np.ndarray
    pointwise: np.ndarray
    pareto_k: Any = None
    good_k: float | None = None
    warning: bool | None = None


def _crps_chunk(ll, x, x2, y, perms, *, tail_max: int, scale: bool, type: str = "mean",
                probs=None):
    """Pointwise (S)CRPS and Pareto k of a ``(B, S)`` chunk.

    ``E|X-y|`` under the PSIS weights of ``-ll``; ``E|X-X'|`` averaged over
    the ``(P, S)`` draw permutations ``perms``, each under the joint
    two-sample weights of ``-ll - ll[:, perm]`` (``pyloo_tpu``'s
    ``streaming._crps_chunk``, reference ``pyloo/loo_score.py:277-346``).
    ``type`` / ``probs`` pick the expectation, as ``e_loo``'s do; a
    quantile's scores are ``(B, n_probs)``.
    """
    neg = -ll
    lw, k = psislw_batch(neg, tail_max)
    EXy = weighted_expectation_batch((x - y[:, None]).abs(), lw, type, probs)
    del lw
    EXX = torch.zeros_like(EXy)
    for perm in perms:
        jlw, _ = psislw_batch(neg - ll.index_select(1, perm), tail_max)
        EXX = EXX + weighted_expectation_batch(
            (x - x2.index_select(1, perm)).abs(), jlw, type, probs
        )
        del jlw
    EXX = EXX / perms.shape[0]
    return _crps(EXX, EXy, scale), k


def _crps(EXX, EXy, scale: bool = False):
    """crps = 0.5*EXX - EXy; scrps = -EXy/EXX - 0.5 log EXX (tensors or arrays)."""
    log = torch.log if isinstance(EXX, torch.Tensor) else np.log
    if scale:
        return -EXy / EXX - 0.5 * log(EXX)
    return 0.5 * EXX - EXy


def _expectation_kind(kind: str, probs):
    """``e_loo``'s checks of ``type`` and ``probs``; the probabilities as a tuple."""
    if kind not in ("mean", "variance", "sd", "quantile"):
        raise ValueError("type must be 'mean', 'variance', 'sd' or 'quantile'")
    if kind != "quantile":
        return kind, None
    if probs is None:
        raise ValueError("probs must be provided for quantile calculation")
    probs = np.atleast_1d(np.asarray(probs, dtype=np.float64))
    if not np.all((probs > 0) & (probs < 1)):
        raise ValueError("probs must be between 0 and 1")
    return kind, tuple(float(p) for p in probs)


def _estimates(score_pw):
    score_value = float(score_pw.mean())
    score_se = float(score_pw.std() / np.sqrt(score_pw.size))
    return np.array([(score_value, score_se)], dtype=[("Estimate", float), ("SE", float)])[0]


def _warn_high_k(result, pareto_k, n_samples):
    """Set ``pareto_k``, ``good_k`` and ``warning`` on ``result``, warning
    when some k is above the threshold (reference ``loo_score.py:115-134``)."""
    good_k = good_k_threshold(n_samples)
    result.pareto_k = pareto_k
    result.good_k = good_k
    k_values = np.asarray(getattr(pareto_k, "values", pareto_k))
    if np.any(k_values > good_k):
        n_high_k = int(np.sum(k_values > good_k))
        warnings.warn(
            "Estimated shape parameter of Pareto distribution is greater than"
            f" {good_k:.2f} for {n_high_k} observations. This indicates that"
            " importance sampling may be unreliable because the marginal posterior"
            " and LOO posterior are very different.",
            UserWarning,
            stacklevel=3,
        )
        result.warning = True
    else:
        result.warning = False


def draw_permutations(seed, permutations: int, n_samples: int) -> np.ndarray:
    """The ``(P, S)`` draw pairings: one ``rng.permutation(S)`` each, from
    ``np.random.default_rng(seed)``, in ``pyloo_tpu``'s order."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n_samples) for _ in range(permutations)])


def loo_score(
    data,
    x_group: str = "posterior_predictive",
    x_var: str | None = None,
    x2_group: str | None = None,
    x2_var: str | None = None,
    y_group: str = "observed_data",
    y_var: str | None = None,
    var_name: str | None = None,
    pointwise: bool | None = None,
    permutations: int = 1,
    reff: float | None = None,
    scale: bool = False,
    seed: int | None = None,
    **kwargs,
) -> LooScoreResult:
    """Leave-one-out (S)CRPS from two sets of predictive draws.

    ``x`` and ``x2`` are independent predictive sample sets (same shapes);
    ``scale=True`` computes SCRPS ``-E|X-y|/E|X-X'| - 0.5 log E|X-X'|``.
    ``permutations`` averages several shuffled pairings of x2, drawn from
    ``np.random.default_rng(seed)``, to reduce the variance of E|X-X'|.
    The keyword arguments go to both expectations, as ``pyloo_tpu``'s go to
    its two ``e_loo`` calls: ``type`` and ``probs`` (``type="quantile",
    probs=0.5`` takes weighted medians; a quantile's pointwise scores gain a
    trailing axis of the probabilities).  The work runs on
    ``rcParams["device.device"]`` in row chunks.
    """
    unknown = set(kwargs) - {"type", "probs"}
    if unknown:
        raise TypeError(f"loo_score got unexpected keyword arguments {sorted(unknown)}")
    kind, probs = _expectation_kind(kwargs.get("type", "mean"), kwargs.get("probs"))
    inference_data = to_inference_data(data)
    log_likelihood = get_log_likelihood(inference_data, var_name=var_name)
    pointwise = rcParams["stats.ic_pointwise"] if pointwise is None else pointwise
    if permutations < 1:
        raise ValueError("permutations must be a positive integer")

    x_data, x2_data, y_data, log_likelihood = _get_data(
        inference_data, x_group=x_group, x_var=x_var, x2_group=x2_group, x2_var=x2_var,
        y_group=y_group, y_var=y_var, log_likelihood=log_likelihood,
    )
    _validate_crps_input(x_data, x2_data, y_data, log_likelihood)

    n_samples = x_data.sizes["__sample__"]
    reff = compute_reff(inference_data, reff, n_samples)

    ll, _, ll_rebuild = as_sample_matrix(log_likelihood)
    x, _, _ = as_sample_matrix(x_data)
    x2, _, _ = as_sample_matrix(x2_data)
    obs_dims = [d for d in x_data.dims if d != "__sample__"]
    y_aligned = y_data.transpose(*obs_dims).values if obs_dims else y_data.values
    y = torch.as_tensor(np.asarray(y_aligned).reshape(-1)).to(x.device, x.dtype)
    _warn_non_finite(x, x2, y)

    perms = torch.from_numpy(draw_permutations(seed, permutations, n_samples))
    tail_max = tail_length(n_samples, reff)
    score, k = apply_rowwise(
        lambda *rows: _crps_chunk(*rows, perms.to(rows[0].device), tail_max=tail_max,
                                  scale=scale, type=kind, probs=probs),
        (ll, x, x2, y),
        extra_buffers=_SCORE_EXTRA_BUFFERS,
    )
    del ll, x, x2
    x_obs_shape = tuple(x_data.sizes[d] for d in obs_dims)
    score_pw = _host(score).reshape(x_obs_shape + tuple(score.shape[1:]))

    result = LooScoreResult(estimates=_estimates(score_pw), pointwise=score_pw)
    if pointwise:
        _, pareto_k = ll_rebuild(None, _host(k))
        if isinstance(pareto_k, DataArray):
            pareto_k = pareto_k.rename("pareto_shape")
        _warn_high_k(result, pareto_k, n_samples)
    return result


def _warn_non_finite(x, x2, y) -> None:
    """The NaN and infinity warnings of reference ``loo_score.py:349-414``,
    scanned on the device one block of rows at a time."""

    def found(predicate):
        return (_any_rowblock(x, predicate) or _any_rowblock(x2, predicate)
                or bool(predicate(y).any()))

    if found(torch.isnan):
        warnings.warn(
            "NaN values detected in input data. These may lead to unreliable results.",
            UserWarning,
            stacklevel=3,
        )
    if found(torch.isinf):
        warnings.warn(
            "Infinite values detected in input data. These may lead to unreliable results.",
            UserWarning,
            stacklevel=3,
        )


def _validate_crps_input(x, x2, y, log_lik=None) -> None:
    """Shape checks of reference ``loo_score.py:349-414``; the NaN and
    infinity warnings come from :func:`_warn_non_finite` on the device."""
    if x.dims != x2.dims:
        raise ValueError("x and x2 must have the same dimensions")
    if x.shape != x2.shape:
        raise ValueError("x and x2 must have the same shape")
    x_obs_dims = [d for d in x.dims if d != "__sample__"]
    if set(x_obs_dims) != set(y.dims):
        raise ValueError(
            f"y dimensions {list(y.dims)} are not compatible with x dimensions {x.dims}"
        )
    if log_lik is not None:
        if "__sample__" not in log_lik.dims:
            raise ValueError("log_lik must have '__sample__' dimension")
        ll_obs_dims = [d for d in log_lik.dims if d != "__sample__"]
        if set(ll_obs_dims) != set(x_obs_dims):
            raise ValueError(
                f"log_lik dimensions {log_lik.dims} are not compatible with x"
                f" dimensions {x.dims}"
            )


def _pick_var(group_ds, group_name, var, role):
    if var is None:
        names = list(group_ds.data_vars)
        if len(names) == 1:
            return names[0]
        raise ValueError(
            f"Multiple variables found in {group_name} group. Please specify"
            f" {role} from: {names}"
        )
    if var not in group_ds.data_vars:
        raise ValueError(
            f"Variable '{var}' not found in {group_name} group. Available"
            f" variables: {list(group_ds.data_vars)}"
        )
    return var


def _get_data(
    inference_data: InferenceData,
    x_group="posterior_predictive",
    x_var=None,
    x2_group=None,
    x2_var=None,
    y_group="observed_data",
    y_var=None,
    log_likelihood=None,
) -> Tuple[DataArray, DataArray, DataArray, DataArray | None]:
    """Resolve the x / x2 / y variables and stack sample dims."""
    if not hasattr(inference_data, x_group):
        raise ValueError(f"InferenceData object does not have a {x_group} group")
    x_ds = getattr(inference_data, x_group)
    x_var = _pick_var(x_ds, x_group, x_var, "x_var")
    x_data = x_ds[x_var]

    x2_group = x2_group or x_group
    if not hasattr(inference_data, x2_group):
        raise ValueError(f"InferenceData object does not have a {x2_group} group")
    x2_ds = getattr(inference_data, x2_group)
    x2_var = x2_var or x_var
    if x2_var not in x2_ds.data_vars:
        raise ValueError(
            f"Variable '{x2_var}' not found in {x2_group} group. Available"
            f" variables: {list(x2_ds.data_vars)}"
        )
    x2_data = x2_ds[x2_var]

    if not hasattr(inference_data, y_group):
        raise ValueError(f"InferenceData object does not have a {y_group} group")
    y_ds = getattr(inference_data, y_group)
    y_var = _pick_var(y_ds, y_group, y_var, "y_var")
    y_data = y_ds[y_var]

    if "chain" in x_data.dims and "draw" in x_data.dims:
        x_data = x_data.stack(__sample__=("chain", "draw"))
    if "chain" in x2_data.dims and "draw" in x2_data.dims:
        x2_data = x2_data.stack(__sample__=("chain", "draw"))
    if (
        log_likelihood is not None
        and "chain" in log_likelihood.dims
        and "draw" in log_likelihood.dims
    ):
        log_likelihood = log_likelihood.stack(__sample__=("chain", "draw"))
    return x_data, x2_data, y_data, log_likelihood


def crps(x, x2, y, *, scale: bool = False, permutations: int = 1,
         seed: int | None = None) -> LooScoreResult:
    """Posterior-sample CRPS from two independent predictive draw sets.

    The plain (non-leave-one-out) counterpart of :func:`loo_score`
    (R ``loo::crps`` / ``loo::scrps`` parity), in numpy on the host.  Per
    observation ``i``:

        EXX_i = mean_s |x_si - x2_si|      (E|X - X'|, X' independent)
        EXy_i = mean_s |x_si - y_i|        (E|X - y|)
        crps_i = 0.5 * EXX_i - EXy_i
        scrps_i = -EXy_i / EXX_i - 0.5 * log(EXX_i)     (``scale=True``)

    Parameters
    ----------
    x, x2 : array
        Independent predictive sample sets, shaped ``(S, *obs)`` or
        ``(chain, draw, *obs)`` (flattened to draws).  Must match.
    y : array
        Observed values shaped ``obs``.
    scale : bool
        ``True`` computes SCRPS (Bolin & Wallin 2023) instead of CRPS.
    permutations : int
        Extra random re-pairings of ``x2`` rows averaged into ``EXX`` to
        reduce its variance.  The first pairing is always the identity
        (the caller's ``x``/``x2`` pairing), so ``permutations=1`` is
        deterministic; each additional pairing shuffles with ``seed``.
    """
    x = np.asarray(x, dtype=np.float64)
    x2 = np.asarray(x2, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape != x2.shape:
        raise ValueError("x and x2 must have the same shape")
    if x.ndim == y.ndim + 2:  # (chain, draw, *obs) -> (S, *obs)
        x = x.reshape((-1,) + x.shape[2:])
        x2 = x2.reshape((-1,) + x2.shape[2:])
    if x.shape[1:] != y.shape:
        raise ValueError(f"x has observation shape {x.shape[1:]}, y has {y.shape}")
    if permutations < 1:
        raise ValueError("permutations must be >= 1")
    S = x.shape[0]
    if np.isnan(x).any() or np.isnan(x2).any() or np.isnan(y).any():
        warnings.warn(
            "NaN values detected in input data. These may lead to unreliable results.",
            UserWarning,
            stacklevel=2,
        )

    EXX = np.abs(x - x2).mean(axis=0)
    if permutations > 1:
        rng = np.random.default_rng(seed)
        for _ in range(permutations - 1):
            EXX = EXX + np.abs(x - x2[rng.permutation(S)]).mean(axis=0)
        EXX = EXX / permutations
    EXy = np.abs(x - y[None]).mean(axis=0)

    score_pw = _crps(EXX, EXy, scale=scale)
    return LooScoreResult(estimates=_estimates(score_pw), pointwise=score_pw)


def scrps(x, x2, y, *, permutations: int = 1, seed: int | None = None) -> LooScoreResult:
    """Posterior-sample SCRPS (scaled CRPS); see :func:`crps`."""
    return crps(x, x2, y, scale=True, permutations=permutations, seed=seed)
