"""Pareto-smoothed / truncated / standard importance sampling, batched.

Counterpart of ``pyloo_tpu/ops/psis.py``: the tail length, the signed-log
Zhang-Stephens fit (:func:`_gpdfit_batch`, float32 and the float64 deep-tail
branch), the linear fit over a renormalized-product profile likelihood
(:func:`_gpdfit_from_y` on exceedances, :func:`_gpdfit_batch_linear` on
their logs; float64), the smoothed weights as a dense matrix
(:func:`psislw_batch`) or as a per-row scalar plus a tail patch
(:func:`psislw_compact_batch`, with :func:`compact_weighted_mean` and
:func:`compact_weighted_moments` to read them), and the SIS / TIS weights.
The order of operations follows ``pyloo_tpu`` line for line: the float64
path is held to it at 1e-12.

The JAX package's ``lax.scan`` over the candidate grid becomes a Python loop
over candidates on ``(B, M)`` tensors, which bounds peak memory at one
``(B, M)`` temporary per step.  The fits take the product form of the
profile likelihood only (``product=True`` at every call site of
``pyloo_tpu``), so the ``log1p``-sum variant and its ``product`` argument
are not ported.

All math follows Vehtari, Simpson, Gelman, Yao, Gabry (2024), "Pareto
smoothed importance sampling", JMLR 25(72), and Zhang & Stephens (2009).
"""

from __future__ import annotations

import math

import torch

from .guard import by_branch, deep_rows
from .lse import logsumexp
from .selection import topk_with_idx
from .topk import _CUTOFF_FLOOR

__all__ = [
    "tail_length",
    "psislw_batch",
    "psislw_compact_batch",
    "compact_weighted_mean",
    "compact_weighted_moments",
    "sislw_batch",
    "tislw_batch",
    "gpdfit",
    "gpinv",
]

_PRIOR_BS = 3.0
_PRIOR_K = 10.0


def tail_length(n_samples: int, reff: float = 1.0) -> int:
    """Maximum tail size M = ceil(min(S/5, 3*sqrt(S/reff)))."""
    return int(math.ceil(min(n_samples / 5.0, 3.0 * math.sqrt(n_samples / reff))))


def _gather_col(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for every row b."""
    return torch.gather(x, 1, idx.long()[:, None])[:, 0]


# ---------------------------------------------------------------------------
# Signed-log arithmetic
# ---------------------------------------------------------------------------


def _softplus(t):
    """log(1 + exp(t)), stable for all t."""
    return torch.clamp_min(t, 0.0) + torch.log1p(torch.exp(-torch.abs(t)))


def _log1mexp(t):
    """log(1 - exp(t)) for t <= 0, stable near both ends (NaN for t > 0)."""
    log2 = math.log(2.0)
    out = torch.where(
        t > -log2,
        torch.log(-torch.expm1(torch.clamp_max(t, 0.0))),
        torch.log1p(-torch.exp(t)),
    )
    return out + torch.zeros_like(t).masked_fill_(t > 0, math.nan)


def _signed_add(sign_a, log_a, sign_b, log_b):
    """Add two signed-log numbers: returns (sign, log|a + b|)."""
    hi = torch.maximum(log_a, log_b)
    lo = torch.minimum(log_a, log_b)
    same = sign_a == sign_b
    mag = torch.where(
        same,
        hi + torch.log1p(torch.exp(lo - hi)),
        hi + _log1mexp(lo - hi),
    )
    # -inf + -inf: both zero
    mag = torch.where(torch.isneginf(hi), -math.inf, mag)
    sign = torch.where(same, sign_a, torch.where(log_a >= log_b, sign_a, sign_b))
    return sign, mag


def _log1p_negby(sign_b, log_by):
    """log(1 - b*y) given b*y in signed-log form (sign_b, log|b*y|).

    sign_b < 0: softplus(log|b*y|); sign_b > 0: log(1 - |b*y|), NaN when
    |b*y| >= 1 (the same failure as a direct log1p).
    """
    return torch.where(sign_b < 0, _softplus(log_by), _log1mexp(log_by))


# ---------------------------------------------------------------------------
# Generalized Pareto fits
# ---------------------------------------------------------------------------


def _gpdfit_batch(log_ary, n, log_quart=None, log_last=None):
    """Zhang-Stephens empirical-Bayes GPD fit in signed-log form, per row.

    Exceedances enter as logarithms and every intermediate (the candidate-b
    grid, the posterior-mean b, the scale) is carried in signed-log form, so
    the fit survives exceedance ranges that overflow or underflow a linear
    float32 fit.  Algebraically the reference fit (``pyloo/psis.py:163-208``).

    Parameters
    ----------
    log_ary : (B, M) tensor
        Log exceedances per row in any order; invalid slots hold ``-inf``.
    n : (B,) int tensor
        Number of valid exceedances per row.
    log_quart, log_last : (B,) tensors, optional
        Log of the first-quartile and maximum exceedance order statistics;
        when omitted, ``log_ary`` must be ascending and left-aligned.

    Returns
    -------
    k : (B,) shrunk shape estimate
    sign_sigma, log_sigma : (B,) the scale as ``sign * exp(log)``
    """
    B, M = log_ary.shape
    dtype = log_ary.dtype
    eps = torch.finfo(dtype).eps
    nf = n.to(dtype)

    m_max = 30 + math.isqrt(M)
    m_est = (30.0 + torch.floor(torch.sqrt(nf))).to(dtype)  # (B,)
    grid = torch.arange(1, m_max + 1, dtype=dtype, device=log_ary.device)
    grid_valid = grid[None, :] <= m_est[:, None]  # (B, m_max)

    if log_quart is None:
        log_quart = _gather_col(log_ary, torch.clamp((n + 2) // 4 - 1, 0, M - 1))
    if log_last is None:
        log_last = _gather_col(log_ary, torch.clamp(n - 1, 0, M - 1))

    # b_i = 1/y_max + c_i / (3 * y_quart) with c_i = 1 - sqrt(m_est/(i-0.5)) < 0
    c = 1.0 - torch.sqrt(m_est[:, None] / (grid[None, :] - 0.5))
    log_term2 = torch.log(-c) - math.log(_PRIOR_BS) - log_quart[:, None]
    ones_c = torch.ones_like(c)
    sign_b, log_b = _signed_add(
        log_ary.new_ones((B, 1)), -log_last[:, None] * ones_c, -ones_c, log_term2
    )
    # grid slots beyond m_est have c > 0 (NaN above); pin them to a harmless
    # finite candidate, since NaN would beat the -inf masking below
    sign_b = torch.where(grid_valid, sign_b, 1.0)
    log_b = torch.where(grid_valid, log_b, 0.0)

    # profile log-likelihood of each candidate: masked mean of log1p(-b*y)
    k_grid = torch.stack(
        [
            _log1p_negby(sign_b[:, j, None], log_b[:, j, None] + log_ary).sum(dim=1) / nf
            for j in range(m_max)
        ],
        dim=1,
    )  # (B, m_max)

    # log(-(b/k)) = log|b| - log|k| when b and k have opposite signs, NaN otherwise
    log_neg_b_over_k = torch.where(
        sign_b * torch.sign(k_grid) < 0,
        log_b - torch.log(torch.abs(k_grid)),
        math.nan,
    )
    len_scale = nf[:, None] * (log_neg_b_over_k - k_grid - 1.0)
    len_scale = torch.where(grid_valid, len_scale, -math.inf)
    ls_max = len_scale.amax(dim=1, keepdim=True)
    w = torch.where(grid_valid, torch.exp(len_scale - ls_max), 0.0)
    w = w / w.sum(dim=1, keepdim=True)
    # prune negligible candidates exactly like the reference (psis.py:194-198)
    w = torch.where(w >= 10.0 * eps, w, 0.0)
    w = w / w.sum(dim=1, keepdim=True)

    # posterior mean b in signed-log form: sum of positive and negative parts
    logw = torch.where(w > 0, torch.log(w), -math.inf)
    wb = logw + log_b
    pos = torch.where(sign_b > 0, wb, -math.inf)
    neg = torch.where(sign_b < 0, wb, -math.inf)
    pos_max = pos.amax(dim=1)
    neg_max = neg.amax(dim=1)
    log_pos = torch.where(
        torch.isneginf(pos_max),
        -math.inf,
        pos_max + torch.log(torch.exp(pos - pos_max[:, None]).sum(dim=1)),
    )
    log_neg = torch.where(
        torch.isneginf(neg_max),
        -math.inf,
        neg_max + torch.log(torch.exp(neg - neg_max[:, None]).sum(dim=1)),
    )
    sign_bp, log_bp = _signed_add(
        log_ary.new_ones((B,)), log_pos, -log_ary.new_ones((B,)), log_neg
    )

    k_post = _log1p_negby(sign_bp[:, None], log_bp[:, None] + log_ary).sum(dim=1) / nf
    # sigma = -k/b: positive when k and b have opposite signs
    sign_sigma = -torch.sign(k_post) * sign_bp
    log_sigma = torch.log(torch.abs(k_post)) - log_bp

    # Degenerate fits: when the posterior-mean b cancels to ~0, k and
    # sigma = -k/b are 0/0 noise; take the exact b -> 0 limit of the GPD,
    # the exponential with k = 0 and sigma = mean(exceedance).
    log_absw_b = torch.logaddexp(log_pos, log_neg)
    cancelled = log_bp < log_absw_b + math.log(256.0 * eps)
    ary_max = log_ary.amax(dim=1)
    safe_max = torch.where(torch.isfinite(ary_max), ary_max, 0.0)
    log_mean_z = (
        safe_max
        + torch.log(torch.exp(log_ary - safe_max[:, None]).sum(dim=1))
        - torch.log(torch.where(nf == 0, 1.0, nf))
    )
    k_post = torch.where(cancelled, 0.0, k_post)
    sign_sigma = torch.where(cancelled, 1.0, sign_sigma)
    log_sigma = torch.where(cancelled, log_mean_z, log_sigma)

    k_post = (nf * k_post + _PRIOR_K * 0.5) / (nf + _PRIOR_K)
    return k_post, sign_sigma, log_sigma


def _candidate_grid_y(y, nf, y_quart, y_last):
    """Zhang-Stephens candidate grid from linear exceedances.

    Returns ``(b, grid_valid)``: the (B, m_max) grid and its per-row validity
    mask (reference ``psis.py:184-188``).
    """
    dtype = y.dtype
    M = y.shape[1]
    m_max = 30 + math.isqrt(M)
    m_est = (30.0 + torch.floor(torch.sqrt(nf))).to(dtype)
    grid = torch.arange(1, m_max + 1, dtype=dtype, device=y.device)
    grid_valid = grid[None, :] <= m_est[:, None]

    # b_i = 1/y_max + c_i / (prior_bs * y_quart), c_i = 1 - sqrt(m_est/(i-.5))
    c = 1.0 - torch.sqrt(m_est[:, None] / (grid[None, :] - 0.5))
    b = 1.0 / y_last[:, None] + c / (_PRIOR_BS * y_quart[:, None])
    b = torch.where(grid_valid, b, 1.0)  # harmless pin beyond the row's grid
    return b, grid_valid


# Renormalized-product profile likelihood: sum_j log1p(-b*y_j) as the log of
# the product of the (positive) factors 1 - b*y_j, accumulated as a pairwise
# tree whose partials stay in [2^-30, 2^30] by exact power-of-two rescaling
# with an integer shift count.  One log per row and candidate instead of M.
_RENORM_HI = 2.0**30
_RENORM_LO = 2.0**-30
_RENORM_SCALE = 2.0**60
_RENORM_INV = 2.0**-60
_LOG_RENORM_SCALE = 60.0 * math.log(2.0)


def _renorm(v, sh):
    """Rescale positive ``v`` toward [2^-30, 2^30] by one exact power of two.

    ``sh`` counts applied rescales (``v_true = v * _RENORM_SCALE**-sh``).
    Zeros and NaNs pass through.
    """
    hi = v > _RENORM_HI
    lo = v < _RENORM_LO
    v = v * torch.where(hi, _RENORM_INV, torch.where(lo, _RENORM_SCALE, v.new_ones(())))
    sh = sh + lo.to(torch.int32) - hi.to(torch.int32)
    return v, sh


def _log_prod_terms(y, b):
    """``sum_j log(1 - b*y_j)`` per row and candidate via a renormalized
    product tree: ``y`` (B, M), ``b`` (B, C) candidates, the result (B, C).

    Invalid slots of ``y`` are exactly 0 (factor 1).  Each multiply carries
    <= eps relative error; the closing log turns them into an absolute error
    of ~2M*eps, with no cancellation since every factor is positive.
    Negative factors (infeasible candidates, ``b*y > 1``) end in NaN, as the
    reference's ``log1p`` does.  Odd level widths carry their last column to
    the next level unmultiplied.  Every operation is elementwise along the
    candidates, so a candidate's value is the same bit for bit whichever
    candidates share its call.
    """
    t = 1.0 - b[:, :, None] * y[:, None, :]
    sh = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    t, sh = _renorm(t, sh)
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        tn = t[..., :h] * t[..., h : 2 * h]
        shn = sh[..., :h] + sh[..., h : 2 * h]
        if t.shape[-1] > 2 * h:
            tn = torch.cat([tn, t[..., 2 * h :]], dim=-1)
            shn = torch.cat([shn, sh[..., 2 * h :]], dim=-1)
        t, sh = _renorm(tn, shn)
    return torch.log(t[..., 0]) - sh[..., 0].to(t.dtype) * _LOG_RENORM_SCALE


# The linear fit's candidates evaluated in one product tree: as many as keep
# a block's (rows, candidates, M) factors within this many bytes, and at
# least one.  Few rows (moment matching's lanes, a split's one row) take the
# whole grid at once, ~100 launches in place of ~100 a candidate; a chunk of
# many rows keeps its one candidate a block, and its memory.
_CANDIDATE_BLOCK_BYTES = 16 << 20


def _linear_b_post(y, nf, b, valid):
    """Posterior-mean b over a candidate set (reference ``psis.py:186-205``).

    ``b`` is (B, C) candidates with validity mask ``valid``; their profile
    log-likelihoods (:func:`_log_prod_terms`) in blocks of candidates within
    ``_CANDIDATE_BLOCK_BYTES``.
    Invalid candidates carry exactly zero weight.
    """
    eps = torch.finfo(y.dtype).eps
    nf_safe = torch.where(nf == 0, 1.0, nf)
    per = max(1, _CANDIDATE_BLOCK_BYTES // max(1, y.numel() * y.element_size()))
    k_grid = torch.cat(
        [_log_prod_terms(y, b[:, j : j + per]) for j in range(0, b.shape[1], per)], dim=1
    ) / nf_safe[:, None]  # (B, m_max)

    len_scale = nf[:, None] * (torch.log(-(b / k_grid)) - k_grid - 1.0)
    len_scale = torch.where(valid, len_scale, -math.inf)
    ls_max = len_scale.amax(dim=1, keepdim=True)
    w = torch.where(valid, torch.exp(len_scale - ls_max), 0.0)
    w = w / w.sum(dim=1, keepdim=True)
    # prune negligible candidates exactly like the reference (psis.py:194-198)
    w = torch.where(w >= 10.0 * eps, w, 0.0)
    w = w / w.sum(dim=1, keepdim=True)
    return (w * b).sum(dim=1)


def _gpdfit_from_y(y, nf, y_quart, y_last):
    """Reference-verbatim Zhang-Stephens fit over linear exceedances.

    ``y`` is (B, M) descending linear exceedances with invalid slots exactly
    0 (the reference's ``exp(x_tail) - exp(cutoff)``, ``psis.py:139-150``).
    Returns ``(k_post, sigma)`` with sigma linear (``sigma = -k_post/b_post``
    before the prior shrinkage of k, ``psis.py:205-208``).
    """
    b, grid_valid = _candidate_grid_y(y, nf, y_quart, y_last)
    b_post = _linear_b_post(y, nf, b, grid_valid)
    nf_safe = torch.where(nf == 0, 1.0, nf)
    k_post = _log_prod_terms(y, b_post[:, None])[:, 0] / nf_safe
    sigma = -k_post / b_post
    k_post = (nf * k_post + _PRIOR_K * 0.5) / (nf + _PRIOR_K)
    return k_post, sigma


def _linear_candidate_grid(log_ary, n, log_quart=None, log_last=None):
    """Shared precomputation for the linear fit: exceedances and b grid.

    Returns ``(y, nf, b, grid_valid)`` with ``y`` the (B, M) linear
    exceedances (invalid slots exactly 0), ``b`` the (B, m_max) candidate
    grid and ``grid_valid`` its per-row validity mask.
    """
    M = log_ary.shape[1]
    nf = n.to(log_ary.dtype)
    y = torch.exp(log_ary)  # invalid slots: exp(-inf) = 0, a factor of 1
    if log_quart is None:
        log_quart = _gather_col(log_ary, torch.clamp((n + 2) // 4 - 1, 0, M - 1))
    if log_last is None:
        log_last = _gather_col(log_ary, torch.clamp(n - 1, 0, M - 1))
    b, grid_valid = _candidate_grid_y(y, nf, torch.exp(log_quart), torch.exp(log_last))
    return y, nf, b, grid_valid


def _linear_fit_close(y, nf, b_post):
    """Final k and sigma from the posterior-mean b (reference ``psis.py:200-207``).

    Returns ``(k_post, sign_sigma, log_sigma)``, the scale in signed-log form
    like :func:`_gpdfit_batch`.
    """
    nf_safe = torch.where(nf == 0, 1.0, nf)
    k_post = _log_prod_terms(y, b_post[:, None])[:, 0] / nf_safe
    sign_sigma = torch.sign(-k_post / b_post)
    log_sigma = torch.log(torch.abs(k_post)) - torch.log(torch.abs(b_post))
    k_post = (nf * k_post + _PRIOR_K * 0.5) / (nf + _PRIOR_K)
    return k_post, sign_sigma, log_sigma


# Deep-tail guard for the linear float64 fit: exceedances are max-shifted
# (log_ary <= 0), so the quartile anchor alone bounds the linear pipeline's
# magnitudes, and IEEE float64 overflows in it for quartiles below ~e^-705
# (pyloo_tpu sets the guard at e^-60 for the TPU's emulated float64; the same
# value is kept so that both packages take the same branch on the same rows).
_LINEAR_FIT_MIN_LOG_QUART = -60.0


def _linear_fit(log_ary, n, log_quart, log_last):
    y, nf, b, grid_valid = _linear_candidate_grid(log_ary, n, log_quart, log_last)
    return _linear_fit_close(y, nf, _linear_b_post(y, nf, b, grid_valid))


def _gpdfit_batch_linear(log_ary, n, log_quart=None, log_last=None):
    """Reference-verbatim Zhang-Stephens fit in the linear domain (float64).

    Requires ``log_ary <= 0`` (exceedances of max-shifted log weights).
    Formula for formula the reference fit (``psis.py:163-208``).  Same
    signature and returns as :func:`_gpdfit_batch`.

    Deep tails (a quartile exceedance below ``e**-60`` on a row with more
    than 4 exceedances) send the rows of their decision group to the
    signed-log fit, which agrees with the linear one to ~1e-14 where both
    are defined: ``pyloo_tpu``'s rule over its batch, here over the group
    :mod:`.guard` says.
    """
    M = log_ary.shape[1]
    if log_quart is None:
        log_quart = _gather_col(log_ary, torch.clamp((n + 2) // 4 - 1, 0, M - 1))
    if log_last is None:
        log_last = _gather_col(log_ary, torch.clamp(n - 1, 0, M - 1))
    # rows with <= 4 exceedances never smooth and may carry -inf anchors:
    # they do not force the signed-log fit; NaN anchors compare False and do
    in_range = (n <= 4) | (log_quart >= _LINEAR_FIT_MIN_LOG_QUART)
    return by_branch(deep_rows(in_range), _linear_fit, _gpdfit_batch,
                     log_ary, n, log_quart, log_last)


def _gpdfit_dispatch(log_exceed, n_tail, log_quart, log_last):
    """The fit for max-shifted PSIS exceedances (log values <= 0).

    float64 takes the reference-verbatim linear fit, float32 the signed-log
    fit (linear float32 exceedances underflow below ~e^-88).
    """
    if log_exceed.dtype == torch.float64:
        return _gpdfit_batch_linear(log_exceed, n_tail, log_quart=log_quart, log_last=log_last)
    return _gpdfit_batch(log_exceed, n_tail, log_quart=log_quart, log_last=log_last)


def gpdfit(ary):
    """Fit a GPD to an ascending sample (1-D, or rows of a 2-D tensor).

    Convenience entry point over :func:`_gpdfit_batch` for full rows; mirrors
    reference ``pyloo/psis.py:163-208``.  Returns ``(k, sigma)``.
    """
    ary = torch.as_tensor(ary)
    squeeze = ary.dim() == 1
    if squeeze:
        ary = ary[None, :]
    n = torch.full((ary.shape[0],), ary.shape[1], dtype=torch.int32, device=ary.device)
    k, sign_sigma, log_sigma = _gpdfit_batch(torch.log(ary), n)
    sigma = sign_sigma * torch.exp(log_sigma)
    if squeeze:
        return k[0], sigma[0]
    return k, sigma


def _gpinv_masked(probs, kappa, sigma, valid):
    """Inverse GPD CDF at plotting positions, with per-row parameters.

    probs: (B, M) in (0, 1) where ``valid``; kappa, sigma: (B,).  Reference
    semantics (``pyloo/psis.py:211-231``): ``sigma <= 0`` poisons the row with
    NaN; near-zero kappa takes the exponential limit.
    """
    eps = torch.finfo(probs.dtype).eps
    kap = kappa[:, None]
    log1m = torch.log1p(-torch.where(valid, probs, 0.5))
    small_kappa = torch.abs(kap) < eps
    safe_kap = torch.where(small_kappa, 1.0, kap)  # guards the division
    q = torch.where(small_kappa, -log1m, torch.expm1(-safe_kap * log1m) / safe_kap)
    q = q * sigma[:, None]
    return torch.where(sigma[:, None] > 0, q, math.nan)


def gpinv(probs, kappa, sigma):
    """Inverse GPD CDF for one parameter pair (1-D or 2-D ``probs``)."""
    probs = torch.as_tensor(probs)
    was_1d = probs.dim() == 1
    probs = torch.atleast_2d(probs)
    kap = probs.new_full((probs.shape[0],), float(kappa))
    sig = probs.new_full((probs.shape[0],), float(sigma))
    ok = (probs > 0) & (probs < 1)
    q = _gpinv_masked(probs, kap, sig, ok)
    q = torch.where(ok, q, math.nan)
    # the edges probs == 0 and probs == 1, as psis.py:228-230
    q = torch.where(probs == 0, 0.0, q)
    upper = torch.where(kap >= 0, math.inf, -sig / torch.where(kap == 0, 1.0, kap))
    q = torch.where(probs == 1, upper[:, None] * torch.ones_like(q), q)
    q = torch.where(sig[:, None] > 0, q, math.nan)
    return q[0] if was_1d else q


# ---------------------------------------------------------------------------
# PSIS
# ---------------------------------------------------------------------------


def _smoothed_tail_desc(tail_vals, xcutoff, tail_max: int):
    """Element-level tail smoothing in the descending top-k layout.

    Unlike the sums of ``loo_kernels._psis_tail_scores`` this gives a smoothed
    value per element, so the plotting positions follow the reference's
    stable ascending argsort within tied runs (``pyloo/psis.py:152-156``).
    For that, tied values of ``tail_vals`` must come by ascending source
    index (:func:`~.selection.topk_with_idx`).

    Returns ``(smoothed_desc, slot_valid, n_tail, k, smooth_ok)``;
    ``smoothed_desc`` is NaN on sigma <= 0 fits (reference ``gpinv``) and not
    yet truncated at zero.
    """
    dtype = tail_vals.dtype
    B = tail_vals.shape[0]
    device = tail_vals.device

    in_tail = tail_vals > xcutoff[:, None]  # strict, preserves tie semantics
    n_tail = in_tail.sum(dim=1)  # (B,) int64

    # log exceedances in descending layout:
    # log(exp(x) - exp(xcutoff)) = x + log1mexp(xcutoff - x)
    slot = torch.arange(tail_max, device=device)
    slot_valid = slot[None, :] < n_tail[:, None]
    gap = torch.clamp_max(xcutoff[:, None] - tail_vals, 0.0)  # <= 0 for valid slots
    log_exceed = torch.where(slot_valid, tail_vals + _log1mexp(gap), -math.inf)

    # ascending index q_idx maps to descending index n - 1 - q_idx
    q_idx = torch.clamp((n_tail + 2) // 4 - 1, 0, tail_max - 1)
    q_desc = torch.clamp(n_tail - 1 - q_idx, 0, tail_max - 1)
    log_quart = _gather_col(log_exceed, q_desc)
    log_last = log_exceed[:, 0]

    k, sign_sigma, log_sigma = _gpdfit_dispatch(log_exceed, n_tail, log_quart, log_last)

    # Plotting positions: within a run of tied tail values the element at the
    # lower source index gets the lower position.  The selection orders ties
    # by ascending index as the descending slot grows, so the ascending rank
    # of slot d is (n - 1 - run_end) + (d - run_start): n - 1 - d for
    # distinct values, reversed within each tied run.
    nf = n_tail.to(dtype)
    eps = torch.finfo(dtype).eps
    changes = tail_vals[:, 1:] != tail_vals[:, :-1]
    edge = torch.ones((B, 1), dtype=torch.bool, device=device)
    is_run_start = torch.cat([edge, changes], dim=1)
    is_run_end = torch.cat([changes, edge], dim=1)
    run_start = torch.cummax(torch.where(is_run_start, slot[None, :], -1), dim=1).values
    run_end = (
        torch.cummin(torch.where(is_run_end, slot[None, :], tail_max).flip(1), dim=1)
        .values.flip(1)
    )
    asc_rank = (n_tail[:, None] - 1 - run_end) + (slot[None, :] - run_start)
    probs = (asc_rank.to(dtype) + 0.5) / torch.where(nf == 0, 1.0, nf)[:, None]
    log1m_p = torch.log1p(-torch.where(slot_valid, probs, 0.5))
    u = -k[:, None] * log1m_p  # sign(u) == sign(k); expm1(u)/k > 0 always
    log_abs_expm1 = torch.where(u >= 0, u, 0.0) + _log1mexp(-torch.abs(u))
    log_q = torch.where(
        torch.abs(k)[:, None] < eps,
        torch.log(-log1m_p),
        log_abs_expm1 - torch.log(torch.abs(k))[:, None],
    )
    smoothed_desc = torch.logaddexp(log_sigma[:, None] + log_q, xcutoff[:, None])
    # sigma <= 0 poisons the row with NaN, matching reference gpinv semantics
    smoothed_desc = torch.where(sign_sigma[:, None] > 0, smoothed_desc, math.nan)

    smooth_ok = (n_tail > 4) & torch.isfinite(k)
    return smoothed_desc, slot_valid, n_tail, k, smooth_ok


def _select_tail(x, tail_max: int, row_tails=None):
    """Top ``tail_max`` of the shifted rows, their indices and the cutoff
    (the ``tail_max + 1``-th largest, or with ``row_tails`` each row's
    ``row_tails + 1``-th largest, floored at log(float64 tiny))."""
    vals, idx = topk_with_idx(x, tail_max + 1)  # descending, (B, M+1)
    cut = vals[:, tail_max] if row_tails is None else _gather_col(vals, row_tails)
    xcutoff = torch.clamp_min(cut, _CUTOFF_FLOOR)
    return vals, idx[:, :tail_max], xcutoff


def psislw_batch(log_weights, tail_max: int, row_tails=None):
    """Pareto-smooth a batch of log-weight rows.

    Parameters
    ----------
    log_weights : (B, S) tensor
        Raw log importance weights, one row per observation; not written to.
    tail_max : int
        Tail budget M (from :func:`tail_length`).
    row_tails : (B,) int64 tensor, optional
        Each row's own tail budget, at most ``tail_max`` (rows of several
        relative efficiencies in one batch, as moment matching's lanes).
        A row's tail is then the values strictly above its own cutoff, which
        lie in the first ``row_tails`` slots of the top ``tail_max``; the
        slots after them take no part, as in a batch of that budget alone,
        but the fit's sums run over the wider slots, so the result agrees
        with such a batch to rounding, not bit for bit.

    Returns
    -------
    lw : (B, S) tensor
        Smoothed, truncated-at-zero, logsumexp-normalized log weights.
    khat : (B,) tensor
        Pareto shape diagnostic; ``inf`` where the tail had <= 4 exceedances.
    """
    x = log_weights - log_weights.amax(dim=1, keepdim=True)  # a tensor of its own
    vals, tail_idx, xcutoff = _select_tail(x, tail_max, row_tails)
    tail_vals = vals[:, :tail_max]
    smoothed_desc, slot_valid, n_tail, k, smooth_ok = _smoothed_tail_desc(
        tail_vals, xcutoff, tail_max
    )

    # the smoothed tail goes back to its source positions; slots outside the
    # strict tail keep their own value (tail_vals is x at tail_idx)
    use_smoothed = slot_valid & smooth_ok[:, None]
    x.scatter_(1, tail_idx, torch.where(use_smoothed, smoothed_desc, tail_vals))

    # truncate at zero (only when smoothing ran), then self-normalize
    x.masked_fill_(smooth_ok[:, None] & (x > 0), 0.0)
    x -= logsumexp(x, dim=1, keepdim=True)

    khat = torch.where(n_tail <= 4, math.inf, k)
    return x, khat


def psislw_compact_batch(log_weights, tail_max: int):
    """Scatter-free PSIS: the weights of :func:`psislw_batch` without the
    ``(B, S)`` smoothed matrix.

    The smoothed row differs from the raw row only at the <= M tail
    positions, so the weights are a per-row scalar plus an ``O(M)`` patch:

        lw[b, s] = log_weights[b, s] - log_norm[b]      for s not in tail_idx
        lw[b, tail_idx[b, j]] = tail_lw[b, j]           for every slot j

    (the second line also holds for slots beyond the strict tail, which
    carry the first line's value).

    Returns
    -------
    log_norm : (B,) tensor
        Row normalizer: ``raw - log_norm`` is the final log weight off-tail.
    tail_idx : (B, M) int64 tensor
        Column indices of the top-M candidate tail, descending by value.
    tail_lw : (B, M) tensor
        Final (smoothed, truncated, normalized) log weights at ``tail_idx``.
    xcutoff : (B,) tensor
        The tail cutoff in the shifted domain (``x - rowmax``): readers shift
        the raw rows the same way and compare there, which reproduces the
        selection's membership bit for bit.
    khat : (B,) tensor
        Same diagnostic as :func:`psislw_batch`.
    """
    C1 = log_weights.amax(dim=1)
    x = log_weights - C1[:, None]
    vals, tail_idx, xcutoff = _select_tail(x, tail_max)
    tail_vals = vals[:, :tail_max]
    smoothed_desc, slot_valid, n_tail, k, smooth_ok = _smoothed_tail_desc(
        tail_vals, xcutoff, tail_max
    )

    use_smoothed = slot_valid & smooth_ok[:, None]
    scatter_vals = torch.where(use_smoothed, smoothed_desc, tail_vals)
    scatter_vals = torch.where(smooth_ok[:, None] & (scatter_vals > 0), 0.0, scatter_vals)

    # normalizer without the scatter: the elements strictly above the cutoff
    # are exactly the valid slots, so the row's logsumexp is the non-tail
    # mass under the value mask plus the (possibly smoothed) valid slots
    m1 = torch.gather(vals, 1, n_tail[:, None])[:, 0]
    m1s = torch.where(torch.isfinite(m1), m1, 0.0)
    nontail_mask = x <= xcutoff[:, None]
    log_ntl = m1s + torch.log(
        torch.where(nontail_mask, torch.exp(x - m1s[:, None]), 0.0).sum(dim=1)
    )
    lse_valid = logsumexp(torch.where(slot_valid, scatter_vals, -math.inf), dim=1)
    denom = torch.logaddexp(log_ntl, lse_valid)

    log_norm = C1 + denom
    tail_lw = scatter_vals - denom[:, None]
    khat = torch.where(n_tail <= 4, math.inf, k)
    return log_norm, tail_idx, tail_lw, xcutoff, khat


def _compact_weights(log_weights, log_norm, tail_idx, tail_lw, xcutoff):
    """Non-tail weights over the raw rows and the strict-tail slots' weights.

    The membership comparison runs in the shifted domain (``raw - rowmax``,
    the subtraction the selection made, in the same dtype), so the cutoff
    order statistic never changes sides from re-rounding.
    """
    x = log_weights - log_weights.amax(dim=1, keepdim=True)
    nontail = x <= xcutoff[:, None]
    w_base = torch.where(nontail, torch.exp(log_weights - log_norm[:, None]), 0.0)
    x_at = torch.gather(x, 1, tail_idx)
    w_tail = torch.where(x_at > xcutoff[:, None], torch.exp(tail_lw), 0.0)
    return w_base, w_tail


def compact_weighted_mean(h, log_weights, log_norm, tail_idx, tail_lw, xcutoff):
    """``E[h]`` per row under compact PSIS weights, scatter-free.

    One pass over the raw ``(B, S)`` matrix restricted by value to the
    non-tail, plus the smoothed contributions of the <= M strict-tail slots:

        E_b = sum_{x <= cutoff} h exp(raw - log_norm)
            + sum_{j: x[idx_j] > cutoff} h[idx_j] exp(tail_lw_j)

    (including the raw tail and subtracting it again would cancel: the raw
    tail can exceed the smoothed normalizer by many orders of magnitude).
    """
    w_base, w_tail = _compact_weights(log_weights, log_norm, tail_idx, tail_lw, xcutoff)
    out = (h * w_base).sum(dim=1) + (torch.gather(h, 1, tail_idx) * w_tail).sum(dim=1)
    # NaN-poisoned rows (sigma <= 0 fits) stay NaN: the masks would drop
    # every term and return 0
    return torch.where(torch.isnan(log_norm), math.nan, out)


def compact_weighted_moments(h, log_weights, log_norm, tail_idx, tail_lw, xcutoff):
    """(mean, unbiased variance) of ``h`` under compact PSIS weights.

    The same evaluation as :func:`compact_weighted_mean`; the three row sums
    of the variance share one pass.  Variance as in
    :func:`..expectations.weighted_variance_batch` (reference
    ``pyloo/e_loo.py:518-531``): ``(E[h^2]-E[h]^2)/(1-sum w^2)`` clamped at
    0, exactly 0 for constant ``h`` and for one dominant weight.
    """
    w_base, w_tail = _compact_weights(log_weights, log_norm, tail_idx, tail_lw, xcutoff)
    h_at = torch.gather(h, 1, tail_idx)
    mean = (h * w_base).sum(dim=1) + (h_at * w_tail).sum(dim=1)
    mean_sq = (h**2 * w_base).sum(dim=1) + (h_at**2 * w_tail).sum(dim=1)
    w_sum_sq = (w_base**2).sum(dim=1) + (w_tail**2).sum(dim=1)

    var = torch.clamp_min((mean_sq - mean**2) / (1.0 - w_sum_sq), 0.0)
    constant = torch.isclose(h, h[:, :1]).all(dim=1)
    degenerate = torch.isclose(w_sum_sq, torch.ones_like(w_sum_sq))
    var = torch.where(constant | degenerate, 0.0, var)
    poisoned = torch.isnan(log_norm)
    return torch.where(poisoned, math.nan, mean), torch.where(poisoned, math.nan, var)


# ---------------------------------------------------------------------------
# SIS / TIS
# ---------------------------------------------------------------------------


def sislw_batch(log_weights):
    """Standard IS: normalize rows; diagnostic is ESS = 1/sum(w^2).

    Reference ``pyloo/sis.py:86-106``.
    """
    x = log_weights - log_weights.amax(dim=1, keepdim=True)
    x = x - logsumexp(x, dim=1, keepdim=True)
    ess = 1.0 / (torch.exp(x) ** 2).sum(dim=1)
    return x, ess


def tislw_batch(log_weights):
    """Truncated IS (Ionides 2008): cap at log(Z-bar) + 0.5*log(S), renormalize.

    Reference ``pyloo/tis.py:91-120``.
    """
    S = log_weights.shape[1]
    x = log_weights - log_weights.amax(dim=1, keepdim=True)
    log_z = logsumexp(x, dim=1, keepdim=True) - math.log(S)
    cap = log_z + 0.5 * math.log(S)
    x = torch.minimum(x, cap)
    x = x - logsumexp(x, dim=1, keepdim=True)
    ess = 1.0 / (torch.exp(x) ** 2).sum(dim=1)
    return x, ess
