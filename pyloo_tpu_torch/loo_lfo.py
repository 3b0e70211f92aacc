"""Approximate leave-future-out cross-validation (LFO-CV) for time series.

Counterpart of ``pyloo_tpu/loo_lfo.py``: M-step-ahead predictive assessment
of time-ordered observations (Bürkner, Gabry & Vehtari 2020, the
PSIS-forward scheme of R's ``loo`` ecosystem).  For each target ``i >= L``

    elpd_i = log p(y_{i:i+M-1} | y_{0:i-1})

is estimated with importance weights on the draws of the fit at history
``L``: the log ratio of target ``i`` is the summed log-likelihood of the
observations ``L..i-1``.  The ratio rows and the M-step joint windows are
summed on the host in sequential float64 (:func:`_block_scores` says why);
all ratio rows then go through one batched Pareto smoothing on the device,
and the joint log-sum-exp runs there too, so no weights cross to the host.

With a model ``wrapper``, the model is refit on ``y_{0:i-1}`` wherever a
target's Pareto k̂ exceeds ``k_threshold`` (HMC on the device through
:class:`pyloo_tpu_torch.models.JAXModelWrapper`), and the sweep continues
from there.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from ._common import clean_log_likelihood, compute_device, compute_reff, good_k_threshold, resolve_scale
from .base import _compute_dtype, _host
from .containers import DataArray
from .elpd import ELPDData
from .ops import psislw_batch, tail_length
from .ops.lse import logsumexp
from .parallel import apply_rowwise
from .rcparams import rcParams
from .utils import get_log_likelihood, to_inference_data

__all__ = ["loo_lfo"]

# full-width (chunk, S) buffers beyond the scorers' four: the joint windows
# and the smoothed weights
_LFO_EXTRA_BUFFERS = 2


def _smoothed_lse(ratios, joint, tail_max: int):
    """``(logsumexp(lw + joint), k)`` per row, ``lw`` the PSIS weights of
    ``ratios``; the sum in ``joint``'s float64, as ``pyloo_tpu`` adds them."""
    lw, k = psislw_batch(ratios, tail_max)
    lw = lw.to(joint.dtype)
    lw += joint
    return logsumexp(lw, dim=1), k


def _block_scores(ll_f: np.ndarray, t_max: int, m: int, reff: float):
    """LFO scores of one fit block.

    ``ll_f``: ``(n_future, S)`` log-likelihood of observations ``i*..N-1``
    under the fit at history ``i*``.  Returns host ``(elpd, ks)`` for targets
    ``t = 0..t_max-1`` (``t`` = offset from ``i*``).

    The ratio and joint-window sums are accumulated on the host in
    sequential float64: PSIS tail membership uses strict comparisons, so the
    order of accumulation must be fixed (a parallel scan such as
    ``torch.cumsum`` on CUDA reorders roundoff and can flip tied tail
    members), and the M-step joint is built by direct row adds rather than a
    difference of cumulative sums (which cancels catastrophically on long
    series).  All targets' smoothing then runs in one batched call.
    """
    ll64 = np.asarray(ll_f, dtype=np.float64)
    s = ll64.shape[1]
    cum = np.cumsum(ll64, axis=0)  # sequential: cum[j] = ((r0+r1)+...)+rj
    # joint log-lik of the M-step-ahead window starting at offset t
    joint = ll64[:t_max].copy()
    for j in range(1, m):
        joint += ll64[j : j + t_max]

    device, dtype = compute_device(), _compute_dtype()
    joint_dev = torch.from_numpy(joint).to(device)
    elpd = np.empty(t_max)
    ks = np.zeros(t_max)
    # t = 0: draws come from the exact conditioning set — uniform weights
    elpd[0] = float(logsumexp(joint_dev[0], dim=0)) - np.log(s)
    if t_max > 1:
        ratios = torch.from_numpy(cum[: t_max - 1]).to(device, dtype)  # row t-1: ratio of t
        tail_max = tail_length(s, reff)
        lse, k = apply_rowwise(
            lambda r, j: _smoothed_lse(r, j, tail_max),
            (ratios, joint_dev[1:]),
            extra_buffers=_LFO_EXTRA_BUFFERS,
        )
        elpd[1:] = _host(lse)
        ks[1:] = _host(k)
    return elpd, ks


def loo_lfo(
    data=None,
    L: int | None = None,
    *,
    M: int = 1,
    var_name: str | None = None,
    wrapper=None,
    k_threshold: float | None = None,
    scale: str | None = None,
    reff: float | None = None,
    pointwise: bool | None = None,
    sample_kwargs: dict | None = None,
) -> ELPDData:
    """Approximate leave-future-out cross-validation for time series.

    Parameters
    ----------
    data : InferenceData-convertible, optional
        Posterior **fit on the first L observations only**, carrying a
        log-likelihood group evaluated at **all** N time-ordered
        observations.  Ignored when ``wrapper`` is given (the wrapper is
        refit on the first ``L`` observations instead).
    L : int
        Minimum history length: the first predicted observation is index
        ``L`` (0-based), conditioned on observations ``0..L-1``.
    M : int, default 1
        Predict the joint density of the next ``M`` observations
        (M-step-ahead; ``M=1`` is standard 1-SAP).
    var_name : str, optional
        Log-likelihood variable when several are stored.
    wrapper : JAXModelWrapper, optional
        Enables exact refits whenever a target's Pareto k̂ exceeds
        ``k_threshold``; without it, high-k̂ targets keep their (possibly
        unreliable) PSIS value and a warning summarizes them.
    k_threshold : float, optional
        Refit / reliability threshold; defaults to
        ``min(1 - 1/log10(S), 0.7)``.
    scale : str, optional
        "log" (default), "negative_log", or "deviance".
    reff : float, optional
        Relative MCMC efficiency; computed from the posterior when absent.
    pointwise : bool, optional
        Include per-target ``lfo_i`` and diagnostics (defaults to
        ``rcParams["stats.ic_pointwise"]``).
    sample_kwargs : dict, optional
        Forwarded to ``wrapper.sample_posterior`` at every refit.

    Returns
    -------
    ELPDData
        Rows ``elpd_lfo``/``se``/``lfoic``/... plus per-target values and
        Pareto k̂ when ``pointwise``; ``n_refits``/``refit_indices`` record
        where exact refits happened.
    """
    if L is None:
        raise TypeError("loo_lfo requires the minimum history length L")
    if M < 1:
        raise ValueError(f"M must be >= 1, got {M}")
    pointwise = rcParams["stats.ic_pointwise"] if pointwise is None else pointwise
    scale, scale_value = resolve_scale(scale)

    if wrapper is not None:
        return _lfo_wrapper(
            wrapper, L, M, k_threshold, scale, scale_value, pointwise,
            sample_kwargs or {}, reff,
        )
    if data is None:
        raise TypeError("loo_lfo requires `data` (or a model `wrapper`)")

    inference_data = to_inference_data(data)
    log_likelihood = get_log_likelihood(inference_data, var_name=var_name)
    log_likelihood = log_likelihood.stack(__sample__=("chain", "draw"))
    n_samples = log_likelihood.shape[-1]
    matrix = np.asarray(log_likelihood.values, dtype=np.float64).reshape(-1, n_samples)
    # (N, S), obs axis in time order; the scan runs on the host copy
    matrix = clean_log_likelihood(torch.from_numpy(matrix), context="LFO").numpy()
    n_obs = matrix.shape[0]
    _validate_horizon(L, M, n_obs)
    reff = compute_reff(inference_data, reff, n_samples)
    k_threshold = good_k_threshold(n_samples) if k_threshold is None else k_threshold

    t_max = n_obs - M - L + 1
    elpd, ks = _block_scores(matrix[L:], t_max, M, reff)

    n_high = int(np.sum(ks > k_threshold))
    warn = n_high > 0
    if warn:
        warnings.warn(
            f"{n_high} of {t_max} LFO targets have Pareto k estimates above "
            f"{k_threshold:.2f}; their importance-sampling approximation may be "
            "unreliable. Pass a model `wrapper` to loo_lfo to refit at these "
            "points.",
            UserWarning,
            stacklevel=2,
        )
    return _lfo_result(
        elpd, ks, np.array([], dtype=int), n_samples, L, M, scale, scale_value,
        k_threshold, pointwise, warn,
    )


def _lfo_wrapper(
    wrapper, L, M, k_threshold, scale, scale_value, pointwise, sample_kwargs,
    reff=None,
):
    n_obs = wrapper.n_obs
    _validate_horizon(L, M, n_obs)
    n_targets = n_obs - M - L + 1
    elpd = np.empty(n_targets)
    ks = np.zeros(n_targets)
    refit_at: list[int] = []
    n_samples = None

    try:
        i_star = L
        while i_star <= n_obs - M:
            # (re)fit on observations 0..i_star-1 of the ORIGINAL data
            # (a prior refit left the wrapper holding a shorter history)
            wrapper.reset_data()
            selected, _ = wrapper.select_observations(np.arange(i_star))
            wrapper.set_data(selected)
            idata_fit = wrapper.sample_posterior(**sample_kwargs)
            ll_f = wrapper.log_likelihood_i(np.arange(i_star, n_obs), idata_fit)
            ll_f = np.asarray(ll_f, dtype=np.float64)
            s_fit = ll_f.shape[0] * ll_f.shape[1]
            n_samples = s_fit if n_samples is None else n_samples
            reff_fit = reff if reff is not None else compute_reff(
                idata_fit, None, s_fit
            )
            ll_f = ll_f.reshape(s_fit, -1).T  # (n_future, S)

            t_max = n_obs - M - i_star + 1
            e_blk, k_blk = _block_scores(ll_f, t_max, M, reff_fit)
            if k_threshold is None:
                k_threshold = good_k_threshold(s_fit)

            bad = np.nonzero(k_blk > k_threshold)[0]
            accept = int(bad[0]) if bad.size else t_max
            off = i_star - L
            elpd[off : off + accept] = e_blk[:accept]
            ks[off : off + accept] = k_blk[:accept]
            if accept == t_max:
                break
            refit_at.append(i_star + accept)  # next block starts here (t=0 exact)
            i_star += accept
    finally:
        wrapper.reset_data()

    return _lfo_result(
        elpd, ks, np.asarray(refit_at, dtype=int), n_samples, L, M, scale,
        scale_value, k_threshold, pointwise, warn=False,
    )


def _validate_horizon(L, M, n_obs):
    if not 1 <= L <= n_obs - M:
        raise ValueError(f"L must satisfy 1 <= L <= n_obs - M ({n_obs - M}), got L={L}")


def _lfo_result(
    elpd, ks, refit_indices, n_samples, L, M, scale, scale_value, k_threshold,
    pointwise, warn,
):
    n_targets = elpd.shape[0]
    lfo_i = DataArray(
        scale_value * elpd,
        ("target",),
        {"target": np.arange(L, L + n_targets)},
        "lfo_i",
    )
    elpd_lfo = float(lfo_i.values.sum())
    se = float((n_targets * np.var(lfo_i.values)) ** 0.5)

    rows: list[tuple[str, Any]] = [
        ("elpd_lfo", elpd_lfo),
        ("se", se),
        ("n_samples", n_samples),
        ("n_data_points", n_targets),
        ("L", L),
        ("M", M),
        ("n_refits", len(refit_indices)),
        ("warning", warn),
    ]
    if pointwise:
        rows.append(("lfo_i", lfo_i))
        rows.append(("refit_indices", refit_indices))
    rows += [
        ("scale", scale),
        ("lfoic", -2 * elpd_lfo),
        ("lfoic_se", 2 * se),
    ]
    if pointwise:
        rows += [("pareto_k", ks), ("good_k", k_threshold)]
    return ELPDData(data=[v for _, v in rows], index=[k for k, _ in rows])
