"""Exact K-fold cross-validation over the functional model wrapper.

Counterpart of ``pyloo_tpu/loo_kfold.py`` (reference
``pyloo/loo_kfold.py:22-693``, which is PyMC-only): the refits run through
:class:`pyloo_tpu_torch.models.JAXModelWrapper`, whose posterior sampling is
the HMC of :mod:`pyloo_tpu_torch.models.hmc` on the device; equal-sized
folds run as one batched HMC run
(:func:`pyloo_tpu_torch.models.batched_refit.kfold_refit_batched`).  The
fold-assignment logic (random / stratified with percentile binning / grouped
greedy smallest-fold) is ``pyloo_tpu``'s, with numpy's generators, so the
same seed gives the same folds.

Unlike ``pyloo_tpu``, a failure inside the batched run raises: the
eligibility checks (equal folds, no ``builder``, the default HMC sampler,
known options) decide between the batched and the serial path, and nothing
falls back after the batched run has started.
"""

from __future__ import annotations

import logging
import warnings
from typing import Any

import numpy as np

from ._common import compute_device, resolve_scale
from .containers import DataArray
from .elpd import ELPDData
from .models.batched_refit import kfold_refit_batched
from .models.wrapper import JAXModelWrapper
from .rcparams import rcParams
from .utils import _logsumexp

_log = logging.getLogger(__name__)

__all__ = [
    "loo_kfold",
    "_kfold_split_random",
    "_kfold_split_stratified",
    "_kfold_split_grouped",
]


def loo_kfold(
    data,
    K: int = 10,
    pointwise: bool | None = None,
    folds: np.ndarray | None = None,
    var_name: str | None = None,
    scale: str | None = None,
    save_fits: bool = False,
    progressbar: bool = False,
    stratify: np.ndarray | None = None,
    groups: np.ndarray | None = None,
    random_seed: int | None = None,
    **kwargs: Any,
) -> ELPDData:
    """Exact K-fold CV: refit on each training split, score the held-out fold.

    Parameters
    ----------
    data : JAXModelWrapper
        Wrapper around a fitted functional model (provides refitting and
        held-out log-likelihood evaluation).
    K : int
        Number of folds (clamped to n_obs; K == n_obs is exact LOO-CV).
    folds : array, optional
        Explicit 1-based fold assignments (overrides stratify/groups).
    stratify / groups : arrays, optional
        Build folds preserving a variable's distribution, or keeping groups
        intact (greedy smallest-fold assignment).
    save_fits : bool
        Keep each fold's refitted InferenceData in the result.

    Returns
    -------
    ELPDData with ``elpd_kfold`` / ``p_kfold`` rows (+ ``kfold_i`` pointwise).

    The refits run on ``rcParams["device.device"]``; with ``"cuda"`` and no
    CUDA device this raises.
    """
    compute_device()
    if not isinstance(data, JAXModelWrapper):
        raise TypeError(f"Expected JAXModelWrapper, got {type(data).__name__}")
    wrapper = data
    pointwise = rcParams["stats.ic_pointwise"] if pointwise is None else pointwise

    observed = wrapper.get_observed_data()
    n_obs = len(observed)
    scale, scale_factor = resolve_scale(scale)

    folds, K = _prepare_folds(folds, K, n_obs, stratify, groups, random_seed)

    # in-sample lpd of the original fit for p_kfold
    if wrapper.idata is None or not hasattr(wrapper.idata, "log_likelihood"):
        raise ValueError(
            "wrapper.idata must contain a log_likelihood group for the"
            " original fit (needed for p_kfold)"
        )
    ll_names = list(wrapper.idata.log_likelihood.data_vars)
    ll_full = wrapper.idata.log_likelihood[
        var_name if var_name in ll_names else ll_names[0]
    ].stack(__sample__=("chain", "draw"))
    if np.any(np.isnan(ll_full.values)):
        warnings.warn(
            "NaN values detected in log-likelihood. These will be ignored in the"
            " K-fold calculation.",
            UserWarning,
            stacklevel=2,
        )
        ll_full = DataArray(
            np.where(np.isnan(ll_full.values), -1e10, ll_full.values),
            ll_full.dims,
            dict(ll_full.coords),
        )
    S_full = ll_full.sizes["__sample__"]
    lpds_full = _logsumexp(ll_full.values, b_inv=S_full, axis=-1)

    elpds = np.zeros(n_obs)
    fits: list[Any] | None = [] if save_fits else None

    batched_done = False
    if not save_fits:
        batched_done = _try_folds_batched(wrapper, folds, K, elpds, **kwargs)

    if not batched_done:
        for k in range(1, K + 1):
            if progressbar:
                _log.info(f"Fitting model {k} out of {K}")
            val_idx = np.where(folds == k)[0]
            if len(val_idx) == 0:
                _log.warning(f"Fold {k} is empty, skipping")
                continue
            train_idx = np.where(folds != k)[0]

            fold_fit, fold_elpds = _process_fold(
                wrapper, train_idx, val_idx, save_fits=save_fits, **kwargs
            )
            elpds[val_idx] = fold_elpds
            if save_fits and fold_fit is not None and fits is not None:
                fits.append(fold_fit)

    p_kfold = lpds_full - elpds
    p_kfold_se = float(np.sqrt(n_obs * np.var(p_kfold)))
    elpds = scale_factor * elpds

    elpd_kfold = float(np.sum(elpds))
    se = float(np.sqrt(n_obs * np.var(elpds)))
    p_kfold_sum = float(np.sum(p_kfold))
    kfoldic = -2 * elpd_kfold / scale_factor
    kfoldic_se = 2 * se

    n_samples = S_full
    is_stratified = stratify is not None
    is_grouped = groups is not None

    rows: list[tuple[str, Any]] = [
        ("elpd_kfold", elpd_kfold),
        ("se", se),
        ("p_kfold", p_kfold_sum),
        ("p_kfold_se", p_kfold_se),
        ("n_samples", n_samples),
        ("n_data_points", n_obs),
        ("warning", False),
    ]
    if pointwise:
        rows.append(
            ("kfold_i", DataArray(elpds, ("observation",), name="kfold_i"))
        )
    rows += [
        ("scale", scale),
        ("K", K),
        ("kfoldic", kfoldic),
        ("kfoldic_se", kfoldic_se),
        ("stratified", is_stratified),
        ("grouped", is_grouped),
    ]
    if fits is not None:
        rows.append(("fits", fits))

    result = ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
    result.method = "kfold"
    result.K = K
    result.stratified = is_stratified
    result.grouped = is_grouped
    return result


# sampler options the batched program understands (a subset of fit()'s)
_BATCHED_FOLD_OPTS = {
    "draws", "tune", "chains", "seed", "num_leapfrog", "target_accept",
}


def _try_folds_batched(wrapper, folds, K, elpds, **kwargs) -> bool:
    """Run ALL fold refits as one batched HMC run when eligible.

    Eligible when the folds are equal-sized (identical training shapes),
    the model has static parameter shapes (``builder is None``), and
    sampling uses the default HMC path with no custom sampler or unknown
    option.  Writes the held-out elpds into ``elpds`` and returns True;
    returns False (untouched) for the serial loop to handle.  A failure
    inside the batched run raises.
    """
    model = wrapper.model
    if model.builder is not None:
        return False
    opts = dict(wrapper.sample_kwargs)
    opts.update(kwargs)
    if opts.pop("algorithm", "hmc") != "hmc":
        return False
    if opts.pop("compute_log_likelihood", True) is not True:
        return False
    if not set(opts) <= _BATCHED_FOLD_OPTS:
        return False  # custom sampler / unknown options -> serial path

    val_lists = [np.where(folds == k)[0] for k in range(1, K + 1)]
    sizes = {len(v) for v in val_lists}
    if len(sizes) != 1 or 0 in sizes:
        return False  # ragged folds -> serial path
    train_lists = [np.where(folds != k)[0] for k in range(1, K + 1)]

    fold_elpds, accept = kfold_refit_batched(
        model,
        np.stack(train_lists),
        np.stack(val_lists),
        **opts,
    )
    for v_idx, e_row in zip(val_lists, fold_elpds):
        elpds[v_idx] = e_row
    _log.info(
        f"Batched K-fold: {K} refits in one batched run"
        f" (mean accept {float(np.mean(accept)):.2f})"
    )
    return True


def _process_fold(wrapper, train_idx, val_idx, save_fits=False, **kwargs):
    """Refit on the training subset; lpd of held-out observations."""
    fold_result = None
    fold_elpds = np.zeros(len(val_idx))
    try:
        selected, remaining = wrapper.select_observations(val_idx)
        fold_model = wrapper.model.with_data(**remaining)
        fold_wrapper = JAXModelWrapper(
            fold_model, sample_kwargs=wrapper.sample_kwargs
        )
        idata_k = fold_wrapper.sample_posterior(**kwargs)
        ll_k = fold_wrapper.log_likelihood_i(selected, idata_k)  # (C, T, m)
        C, T, m = ll_k.shape
        ll_flat = ll_k.reshape(C * T, m).T  # (m, S)
        fold_elpds = _logsumexp(ll_flat, b_inv=C * T, axis=-1)
        if save_fits:
            fold_result = (idata_k, val_idx)
    except Exception as e:
        _log.warning(f"Error processing fold: {e}")
    return fold_result, fold_elpds


def _prepare_folds(folds, K, n_obs, stratify, groups, random_seed):
    """Validate explicit folds or build random/stratified/grouped ones."""
    if K <= 0:
        raise ValueError(f"K must be positive, got {K}")
    if K > n_obs:
        _log.warning(f"K ({K}) is greater than N ({n_obs}), setting K=N")
        K = min(K, n_obs)

    if folds is not None:
        if stratify is not None:
            _log.warning(
                "Both folds and stratify were provided. Using the provided folds"
                " and ignoring stratify."
            )
        folds = np.asarray(folds)
        if len(folds) != n_obs:
            raise ValueError(
                f"Length of folds ({len(folds)}) must match observations ({n_obs})"
            )
        unique_folds = np.unique(folds)
        if len(unique_folds) < 2:
            raise ValueError(
                f"Need at least 2 unique fold values, got {len(unique_folds)}"
            )
        if 0 in unique_folds:
            raise ValueError("Fold indices must be >= 1")
        return folds, len(unique_folds)

    if groups is not None:
        groups = np.asarray(groups)
        if len(groups) != n_obs:
            raise ValueError(
                f"Length of groups ({len(groups)}) must match observations ({n_obs})"
            )
        try:
            return _kfold_split_grouped(K=K, groups=groups, seed=random_seed), K
        except Exception as e:
            raise ValueError(f"Failed to create group-based folds: {str(e)}")

    if stratify is not None:
        stratify = np.asarray(stratify)
        if len(stratify) != n_obs:
            raise ValueError(
                f"Length of stratify ({len(stratify)}) must match observations"
                f" ({n_obs})"
            )
        try:
            return _kfold_split_stratified(K=K, x=stratify, seed=random_seed), K
        except Exception as e:
            raise ValueError(f"Failed to create stratified folds: {str(e)}")

    return _kfold_split_random(K=K, N=n_obs, seed=random_seed), K


def _kfold_split_random(K: int, N: int, seed: int | None = None) -> np.ndarray:
    """Random near-equal folds, labels 1..K."""
    rng = np.random.default_rng(seed) if seed is not None else np.random
    folds = np.zeros(N, dtype=int)
    fold_sizes = np.full(K, N // K, dtype=int)
    fold_sizes[: N % K] += 1
    order = rng.permutation(N)
    start = 0
    for i in range(K):
        folds[order[start : start + fold_sizes[i]]] = i + 1
        start += fold_sizes[i]
    return folds


def _kfold_split_stratified(K: int, x, seed: int | None = None) -> np.ndarray:
    """Folds preserving the distribution of x (percentile-binned if continuous)."""
    rng = np.random.default_rng(seed) if seed is not None else np.random
    x = np.asarray(x)
    N = len(x)
    if K <= 1:
        raise ValueError(f"K must be > 1 for stratified folds, got {K}")
    if np.issubdtype(x.dtype, np.number) and np.any(np.isnan(x)):
        raise ValueError("Stratification variable contains NaN values")

    if np.issubdtype(x.dtype, np.number) and len(np.unique(x)) > K:
        bins = np.percentile(x, np.linspace(0, 100, K + 1))
        bins = np.unique(bins)
        x_binned = np.digitize(x, bins[:-1])
    else:
        x_binned = x

    unique_values, counts = np.unique(x_binned, return_counts=True)
    if len(unique_values) == 1 and K > 1:
        _log.warning(
            "Only 1 unique value in stratification variable, using random folds"
            " instead"
        )
        return _kfold_split_random(K=K, N=N, seed=seed)

    folds = np.zeros(N, dtype=int)
    for val, count in zip(unique_values, counts):
        val_indices = rng.permutation(np.where(x_binned == val)[0])
        sizes = np.full(K, count // K, dtype=int)
        sizes[: count % K] += 1
        start = 0
        for k in range(K):
            folds[val_indices[start : start + sizes[k]]] = k + 1
            start += sizes[k]
    if not np.all((folds >= 1) & (folds <= K)):
        raise ValueError(f"Generated fold values outside range 1-{K}")
    return folds


def _kfold_split_grouped(K: int, groups, seed: int | None = None) -> np.ndarray:
    """Whole groups per fold, greedily assigned to the smallest fold."""
    rng = np.random.default_rng(seed) if seed is not None else np.random
    groups = np.asarray(groups)
    unique_groups = np.unique(groups)
    n_groups = len(unique_groups)
    if n_groups < K:
        _log.warning(
            f"Number of groups ({n_groups}) is less than K ({K}). Setting"
            f" K={n_groups}"
        )
        K = n_groups
    if K <= 1:
        raise ValueError(f"K must be > 1 for group-based folds, got {K}")

    group_to_fold = {}
    fold_sizes = np.zeros(K, dtype=int)
    for group_idx in rng.permutation(n_groups):
        fold = int(np.argmin(fold_sizes)) + 1
        group_to_fold[unique_groups[group_idx]] = fold
        fold_sizes[fold - 1] += 1
    return np.array([group_to_fold[g] for g in groups], dtype=int)
