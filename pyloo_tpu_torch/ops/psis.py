"""Pareto-smoothed / truncated / standard importance sampling, batched.

Counterpart of ``pyloo_tpu/ops/psis.py``, limited to what ``loo()`` reaches:
the tail length, the signed-log Zhang-Stephens fit (:func:`_gpdfit_batch`,
float32 and the float64 deep-tail branch), the linear fit over a
renormalized-product profile likelihood (:func:`_gpdfit_from_y`, float64),
and the SIS / TIS weights.  The order of operations follows ``pyloo_tpu``
line for line: the float64 path is held to it at 1e-12.

The JAX package's ``lax.scan`` over the candidate grid becomes a Python loop
over candidates on ``(B, M)`` tensors, which bounds peak memory at one
``(B, M)`` temporary per step.  The fits take the product form of the
profile likelihood only (``product=True`` at every ``pyloo_tpu`` call site
that ``loo()`` reaches), so the ``log1p``-sum variant is not ported.

All math follows Vehtari, Simpson, Gelman, Yao, Gabry (2024), "Pareto
smoothed importance sampling", JMLR 25(72), and Zhang & Stephens (2009).
"""

from __future__ import annotations

import math

import torch

from .lse import logsumexp

__all__ = ["tail_length", "sislw_batch", "tislw_batch"]

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


def _log_prod_terms(y, b_col):
    """``sum_j log(1 - b*y_j)`` per row via a renormalized product tree.

    Invalid slots of ``y`` are exactly 0 (factor 1).  Each multiply carries
    <= eps relative error; the closing log turns them into an absolute error
    of ~2M*eps, with no cancellation since every factor is positive.
    Negative factors (infeasible candidates, ``b*y > 1``) end in NaN, as the
    reference's ``log1p`` does.  Odd level widths carry their last column to
    the next level unmultiplied.
    """
    t = 1.0 - b_col[:, None] * y
    sh = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    t, sh = _renorm(t, sh)
    while t.shape[1] > 1:
        h = t.shape[1] // 2
        tn = t[:, :h] * t[:, h : 2 * h]
        shn = sh[:, :h] + sh[:, h : 2 * h]
        if t.shape[1] > 2 * h:
            tn = torch.cat([tn, t[:, 2 * h :]], dim=1)
            shn = torch.cat([shn, sh[:, 2 * h :]], dim=1)
        t, sh = _renorm(tn, shn)
    return torch.log(t[:, 0]) - sh[:, 0].to(t.dtype) * _LOG_RENORM_SCALE


def _linear_b_post(y, nf, b, valid):
    """Posterior-mean b over a candidate set (reference ``psis.py:186-205``).

    ``b`` is (B, C) candidates with validity mask ``valid``; one candidate's
    profile log-likelihood (:func:`_log_prod_terms`) per loop step.
    Invalid candidates carry exactly zero weight.
    """
    eps = torch.finfo(y.dtype).eps
    nf_safe = torch.where(nf == 0, 1.0, nf)
    k_grid = torch.stack(
        [_log_prod_terms(y, b[:, j]) / nf_safe for j in range(b.shape[1])], dim=1
    )  # (B, m_max)

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
    k_post = _log_prod_terms(y, b_post) / nf_safe
    sigma = -k_post / b_post
    k_post = (nf * k_post + _PRIOR_K * 0.5) / (nf + _PRIOR_K)
    return k_post, sigma


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
