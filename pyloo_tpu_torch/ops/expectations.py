"""Batched weighted expectations (mean / variance / quantile / k-hat).

Counterpart of ``pyloo_tpu/ops/expectations.py`` (reference
``pyloo/e_loo.py:429-559``), per row of ``(B, S)`` tensors.  Every function
is row-wise, so callers may run it over any chunking of the rows
(:func:`~pyloo_tpu_torch.parallel.apply_rowwise`): the quantile's argsort
alone holds int64 indices twice the size of a float32 block.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .lse import logsumexp
from .psis import _gpdfit_batch

__all__ = [
    "weighted_mean_batch",
    "weighted_variance_batch",
    "weighted_quantile_batch",
    "weighted_expectation_batch",
    "khat_batch",
]


def _weights(log_weights):
    return torch.exp(log_weights - logsumexp(log_weights, dim=1, keepdim=True))


def _constant_rows(x):
    return torch.isclose(x, x[:, :1]).all(dim=1)


def weighted_mean_batch(x, log_weights):
    """Row-wise importance-weighted mean: sum(w * x)."""
    return (_weights(log_weights) * x).sum(dim=1)


def weighted_variance_batch(x, log_weights):
    """Unbiased weighted variance (E[x^2]-E[x]^2)/(1-sum(w^2)), clamped at 0.

    Degenerate rows (constant x, or a single dominant weight) return 0,
    mirroring reference ``_wvar_func`` (e_loo.py:518-531).
    """
    w = _weights(log_weights)
    mean = (w * x).sum(dim=1)
    mean_sq = (w * x**2).sum(dim=1)
    w_sum_sq = (w**2).sum(dim=1)
    var = torch.clamp_min((mean_sq - mean**2) / (1.0 - w_sum_sq), 0.0)
    degenerate = torch.isclose(w_sum_sq, torch.ones_like(w_sum_sq))
    return torch.where(_constant_rows(x) | degenerate, 0.0, var)


def weighted_quantile_batch(x, log_weights, probs):
    """Interpolated weighted quantiles per row.  Returns (B, n_probs).

    For each probability p: invert the cumulative weight function at p with
    linear interpolation between adjacent order statistics (reference
    ``_weighted_quantile``, e_loo.py:534-554).  Rows with (near-)constant
    weights use plain linear-interpolation quantiles, matching the
    reference's ``np.quantile`` fallback.

    The sort is stable: where ``x`` has ties with unequal weights, the
    cumulative weight at the first element of a run depends on the order
    inside the run, and the interpolated quantile with it.  All probabilities
    are looked up at once in the ``(B, S)`` cumulative weights; nothing of
    shape ``(n_probs, B, S)`` is made.
    """
    B, S = x.shape
    probs = np.atleast_1d(np.asarray(probs, dtype=np.float64))
    w = _weights(log_weights)
    order = torch.argsort(x, dim=1, stable=True)
    xs = torch.gather(x, 1, order)
    cw = torch.cumsum(torch.gather(w, 1, order), dim=1)
    del order
    cw = cw / cw[:, -1:]
    uniform_row = _constant_rows(w)

    # numpy's default linear interpolation at position (S-1)*p
    pos = (S - 1) * probs
    lo = np.clip(np.floor(pos).astype(np.int64), 0, S - 1)
    hi = np.clip(lo + 1, 0, S - 1)
    frac = torch.as_tensor(pos - lo, dtype=x.dtype, device=x.device)
    x_lo = xs[:, torch.as_tensor(lo, device=x.device)]
    x_hi = xs[:, torch.as_tensor(hi, device=x.device)]
    plain = x_lo + frac * (x_hi - x_lo)

    # first index with cumulative weight >= p; none (or NaN weights): S
    p = torch.as_tensor(probs, dtype=x.dtype, device=x.device).expand(B, -1).contiguous()
    wi = torch.searchsorted(cw, p)
    wi = torch.where(torch.isnan(cw[:, -1:]), S, wi)
    any_ge = wi < S
    wi = torch.clamp_max(wi, S - 1)
    below = torch.clamp_min(wi - 1, 0)
    x_hi, x_lo = torch.gather(xs, 1, wi), torch.gather(xs, 1, below)
    w_hi, w_lo = torch.gather(cw, 1, wi), torch.gather(cw, 1, below)
    interp = x_lo + (x_hi - x_lo) * (p - w_lo) / torch.where(w_hi == w_lo, 1.0, w_hi - w_lo)
    weighted = torch.where(wi == 0, xs[:, :1], torch.where(any_ge, interp, xs[:, -1:]))
    return torch.where(uniform_row[:, None], plain, weighted)


def weighted_expectation_batch(x, log_weights, kind: str, probs=None):
    """The weighted expectation of each row that ``e_loo``'s ``type`` names:
    ``"mean"``, ``"variance"`` or ``"sd"`` as ``(B,)``, ``"quantile"`` at
    ``probs`` as ``(B, n_probs)``."""
    if kind == "mean":
        return weighted_mean_batch(x, log_weights)
    if kind in ("variance", "sd"):
        value = weighted_variance_batch(x, log_weights)
        return torch.sqrt(value) if kind == "sd" else value
    return weighted_quantile_batch(x, log_weights, probs)


def _tail_khat(values, tail_len: int):
    """GPD k of the top ``tail_len`` exceedances of each row of ``values``.

    Fits exceedances over the (tail_len+1)-th largest order statistic.  (The
    reference, e_loo.py:350-357, passes a descending tail whose last element
    is exactly zero into the fit, which collapses k to the constant prior
    value 5/(tail_len+10); this computes the intended diagnostic, as
    ``pyloo_tpu`` does.)
    """
    B = values.shape[0]
    # with fewer draws than the nominal tail, use every draw above the row
    # minimum; rows left with < 5 positive exceedances return inf below
    tail_len = min(tail_len, values.shape[1] - 1)
    if tail_len < 1:
        return values.new_full((B,), math.inf)
    vals = torch.topk(values, tail_len + 1, dim=1, sorted=True).values  # descending
    asc = (vals[:, :tail_len] - vals[:, tail_len :]).flip(1)
    n = (asc > 0).sum(dim=1)
    # ascending order puts the zeros (ties with the cutoff) first: shift the
    # positive exceedances to the left
    slot = torch.arange(tail_len, device=values.device)
    src = torch.clamp(slot[None, :] + (tail_len - n)[:, None], 0, tail_len - 1)
    asc_valid = torch.gather(asc, 1, src)
    log_exceed = torch.where(
        slot[None, :] < n[:, None], torch.log(torch.clamp_min(asc_valid, 1e-300)), -math.inf
    )
    k, _, _ = _gpdfit_batch(log_exceed, n)
    return torch.where((n < 5) | _constant_rows(values), math.inf, k)


def khat_batch(h, log_ratios, tail_len: int = 20, use_h: bool = True):
    """Function-specific Pareto k diagnostic per row (e_loo.py:328-390).

    Fits the right tail of the raw importance ratios and, when ``use_h``,
    both tails of h*r; returns the max.
    """
    r = torch.exp(log_ratios - log_ratios.amax(dim=1, keepdim=True))
    khat_r = _tail_khat(r, tail_len)
    if not use_h:
        return khat_r

    hr = h * r
    k_right = _tail_khat(hr, tail_len)
    k_left = _tail_khat(-hr, tail_len)
    # reference semantics: one-sided failures contribute -inf, and rows where
    # h is degenerate (constant or non-finite) fall back to khat_r
    khat_hr = torch.maximum(
        torch.where(torch.isinf(k_right), -math.inf, k_right),
        torch.where(torch.isinf(k_left), -math.inf, k_left),
    )
    h_bad = _constant_rows(h) | (~torch.isfinite(h)).any(dim=1)
    both_nan = torch.isnan(khat_hr) & torch.isnan(khat_r)
    out = torch.where(h_bad, khat_r, torch.maximum(khat_hr, khat_r))
    return torch.where(both_nan, math.nan, out)
