"""Exact refitting for observations where the PSIS approximation fails.

Counterpart of ``pyloo_tpu/reloo.py`` (reference ``pyloo/reloo.py:28-274``):
keep PSIS-LOO for well-behaved observations; for each observation with
Pareto k above the threshold, refit the model without it (HMC on the device
through the wrapper) and compute the exact leave-one-out lpd.  Every such
refit trains on n-1 observations, so they run as one batched HMC run when
the model and sampler allow it; a failure inside that run raises, where
``pyloo_tpu`` falls back to serial refits.
"""

from __future__ import annotations

import logging

import numpy as np

from ._common import compute_device
from .elpd import ELPDData
from .loo import loo
from .loo_kfold import _BATCHED_FOLD_OPTS
from .loo_subsample import loo_subsample
from .models.batched_refit import kfold_refit_batched
from .models.wrapper import JAXModelWrapper
from .utils import _logsumexp

_log = logging.getLogger(__name__)

__all__ = ["reloo"]

_REQUIRED_METHODS = (
    "select_observations",
    "set_data",
    "sample_posterior",
    "log_likelihood_i",
)


def _try_reloo_batched(
    wrapper, bad, khats, loo_i, scale_value,
    use_subsample, subsample_observations, verbose,
) -> bool:
    """Run ALL leave-one-out refits as one batched HMC run.

    Every reloo refit trains on n-1 observations — identical shapes — so
    the bad-observation set batches exactly like equal-sized k-folds
    (:func:`pyloo_tpu_torch.models.batched_refit.kfold_refit_batched` with
    ``n_val = 1``).  Eligibility mirrors the k-fold fast path: static
    parameter shapes, default HMC, no custom sampler.  Returns False to
    let the serial loop handle it; a failure inside the batched run raises.
    """
    if len(bad) == 0 or any(idx.size > 1 for idx in bad):
        return False  # multidimensional observation indices: serial path
    model = wrapper.model
    if model.builder is not None:
        return False
    opts = dict(wrapper.sample_kwargs)
    if opts.pop("algorithm", "hmc") != "hmc":
        return False
    if opts.pop("compute_log_likelihood", True) is not True:
        return False
    if not set(opts) <= _BATCHED_FOLD_OPTS:
        return False

    flat = [int(i.item()) for i in bad]
    if use_subsample and isinstance(subsample_observations, np.ndarray):
        orig = [int(subsample_observations[i]) for i in flat]
    else:
        orig = flat
    n = wrapper.n_obs
    all_idx = np.arange(n)
    train_idx = np.stack([all_idx[all_idx != i] for i in orig])  # (B, n-1)
    val_idx = np.asarray(orig)[:, None]  # (B, 1)

    elpd, accept = kfold_refit_batched(model, train_idx, val_idx, **opts)
    if verbose:
        _log.info(
            f"Batched reloo: {len(flat)} leave-one-out refits in one batched"
            f" run (mean accept {float(np.mean(accept)):.2f})"
        )
    k_arr = khats.values if hasattr(khats, "values") else khats
    for j, i in enumerate(flat):
        loo_i.values[i] = scale_value * float(elpd[j, 0])
        k_arr[i] = 0
    return True


def reloo(
    wrapper: JAXModelWrapper,
    loo_orig: ELPDData | None = None,
    k_thresh: float = 0.7,
    scale: str | None = None,
    verbose: bool = True,
    use_subsample: bool = False,
    subsample_observations=400,
    subsample_approximation: str = "plpd",
    subsample_estimator: str = "diff_srs",
    subsample_draws: int | None = None,
) -> ELPDData:
    """Recompute LOO exactly for the observations PSIS cannot handle.

    Observations with ``pareto_k > k_thresh`` get a full model refit with
    that observation held out; their pointwise elpd becomes the exact
    refitted lpd and their k is set to 0.  With ``use_subsample`` the
    initial pass runs :func:`loo_subsample`.

    The refits run on ``rcParams["device.device"]``; with ``"cuda"`` and no
    CUDA device this raises.
    """
    compute_device()
    not_implemented = [
        m
        for m in _REQUIRED_METHODS
        if not callable(getattr(wrapper, m, None))
    ]
    if not_implemented:
        raise TypeError(
            "Passed wrapper instance does not implement all methods required for"
            f" reloo. Check the documentation of JAXModelWrapper. {not_implemented}"
            " must be implemented and were not found."
        )

    if loo_orig is None:
        if use_subsample:
            loo_orig = loo_subsample(
                wrapper.idata,
                observations=subsample_observations,
                loo_approximation=subsample_approximation,
                estimator=subsample_estimator,
                loo_approximation_draws=subsample_draws,
                pointwise=True,
                scale=scale,
            )
        else:
            loo_orig = loo(wrapper.idata, pointwise=True, scale=scale)

    loo_refitted = loo_orig.copy()
    khats = loo_refitted.pareto_k
    loo_i = loo_refitted.loo_i
    scale = loo_orig["scale"] if scale is None else scale
    scale = "log" if scale is None else scale
    scale_value = {"deviance": -2, "log": 1, "negative_log": -1}[scale.lower()]

    lppd_orig = loo_orig["p_loo"] + loo_orig["elpd_loo"] / scale_value
    n_data_points = loo_orig["n_data_points"]

    khats_values = khats.values if hasattr(khats, "values") else np.asarray(khats)
    if not np.any(khats_values > k_thresh):
        if verbose:
            _log.info("No problematic observations found")
        return loo_orig

    bad = np.argwhere(khats_values > k_thresh)
    batched = _try_reloo_batched(
        wrapper, bad, khats, loo_i, scale_value,
        use_subsample, subsample_observations, verbose,
    )
    if not batched:
        for idx in bad:
            flat_idx = int(idx.item()) if idx.size == 1 else tuple(idx)
            if verbose:
                _log.info("Refitting model excluding observation %s", flat_idx)

            if use_subsample and isinstance(subsample_observations, np.ndarray):
                orig_idx = int(subsample_observations[flat_idx])
            else:
                orig_idx = flat_idx

            try:
                selected, remaining = wrapper.select_observations(orig_idx)
                wrapper.set_data(remaining)
                idata_idx = wrapper.sample_posterior()
                ll_idx = wrapper.log_likelihood_i(selected, idata_idx).flatten()
                loo_lppd_idx = scale_value * _logsumexp(ll_idx, b_inv=len(ll_idx))
                if hasattr(khats, "values"):
                    khats.values[idx if idx.size > 1 else flat_idx] = 0
                else:
                    khats[flat_idx] = 0
                loo_i.values[flat_idx] = loo_lppd_idx
            finally:
                wrapper.reset_data()

    loo_refitted["elpd_loo"] = float(loo_i.values[~np.isnan(loo_i.values)].sum())
    loo_refitted["se"] = float(
        (n_data_points * np.var(loo_i.values[~np.isnan(loo_i.values)])) ** 0.5
    )
    loo_refitted["p_loo"] = lppd_orig - loo_refitted["elpd_loo"] / scale_value
    return loo_refitted
