"""Per-observation LOO score kernels.

Counterpart of ``pyloo_tpu/ops/loo_kernels.py``.  Each scorer computes, from
a raw ``(B, S)`` log-likelihood block, everything ``loo()`` needs per
observation: the IS-weighted elpd, the diagnostic, and the in-sample lppd.

Two PSIS variants share one scoring core (:func:`_psis_tail_scores`):

* :func:`loo_scores_psis` — the reference-exact float64 path (NaN poisoning
  of sigma <= 0 fits, strict-``>`` tie membership, the linear fit);
* :func:`loo_scores_psis_fast` — the float32 throughput path through the
  fused prepass (kernel A on the card) and the fused tail fit (kernel F,
  :func:`psis_tail_fit`, whose plain version is the scoring core); rows whose
  fit degenerates keep their unsmoothed tail and are flagged in a fourth
  output.

Both close the elpd over the compact top-(M+1) tail: with ``x = -ll - C``
(C the row max of ``-ll``), every non-tail element has ``x_smoothed + ll =
-C`` exactly, so

    lse(x_s + ll) = -C + log((S - n_tail) + sum_tail exp(s_j - x_j))
    lse(x_s)      = log(sum_nontail exp(x) + sum_tail exp(s_j))

and nothing is scattered back into the ``(B, S)`` array.
"""

from __future__ import annotations

import math

import torch

from .. import _build, profiling
from .guard import by_branch, deep_rows
from .lse import logsumexp
from .psis import (
    _LINEAR_FIT_MIN_LOG_QUART,
    _gpdfit_batch,
    _gpdfit_from_y,
    _log1mexp,
    sislw_batch,
    tislw_batch,
)
from .selection import fast_path_route, topk_vals_desc
from .topk import (
    _CUTOFF_FLOOR,
    MAX_K,
    _count_on,
    _launch_args,
    _raise_on,
    loo_prepass,
    loo_prepass_multi,
    multipass_parts,
    topk_desc_plain,
)

__all__ = [
    "loo_scores_psis",
    "loo_scores_psis_fast",
    "psis_tail_fit",
    "psis_tail_fit_plain",
    "loo_scores_sis",
    "loo_scores_tis",
    "mixture_scores",
    "waic_scores",
]


def _log_domain_smooth(tail_vals, xcutoff, slot_valid, n_tail, q_desc, log1m_p):
    """The tail's fit and smoothed values in the log domain end to end:
    float32's only option (linear weights underflow below e^-88), and
    float64's deep-tail branch.  Returns ``(k, smoothed, sigma > 0)``."""
    eps = torch.finfo(tail_vals.dtype).eps
    gap = torch.clamp_max(xcutoff[:, None] - tail_vals, 0.0)
    log_exceed = torch.where(slot_valid, tail_vals + _log1mexp(gap), -math.inf)
    log_quart = torch.gather(log_exceed, 1, q_desc)[:, 0]
    k, sign_sigma, log_sigma = _gpdfit_batch(
        log_exceed, n_tail, log_quart=log_quart, log_last=log_exceed[:, 0]
    )
    u = -k[:, None] * log1m_p
    abs_u = torch.abs(u)
    log_abs_expm1 = torch.where(u >= 0, u, 0.0) + _log1mexp(-abs_u)
    log_q = torch.where(
        torch.abs(k)[:, None] < eps,
        torch.log(-log1m_p),
        log_abs_expm1 - torch.log(torch.abs(k))[:, None],
    )
    smoothed = torch.logaddexp(log_sigma[:, None] + log_q, xcutoff[:, None])
    smoothed = torch.clamp_max(smoothed, 0.0)  # truncate weights at exp(0)
    return k, smoothed, sign_sigma > 0


def _linear_smooth(tail_vals, xcutoff, slot_valid, n_tail, q_desc, log1m_p):
    """Reference-verbatim linear pipeline (psis.py:138-157): exceedances
    exp(x_tail) - exp(cutoff), linear fit, linear gpinv, one closing log."""
    eps = torch.finfo(tail_vals.dtype).eps
    nf = n_tail.to(tail_vals.dtype)
    expxcutoff = torch.exp(xcutoff)
    y = torch.where(slot_valid, torch.exp(tail_vals) - expxcutoff[:, None], 0.0)
    y_quart = torch.gather(y, 1, q_desc)[:, 0]
    k, sigma = _gpdfit_from_y(y, nf, y_quart, y[:, 0])
    # sigma/k as one per-row factor, in pyloo_tpu's order
    sig_over_k = sigma / torch.where(k == 0, 1.0, k)
    q_lin = torch.where(
        torch.abs(k)[:, None] < eps,
        sigma[:, None] * -log1m_p,
        sig_over_k[:, None] * torch.expm1(-k[:, None] * log1m_p),
    )
    smoothed = torch.clamp_max(torch.log(q_lin + expxcutoff[:, None]), 0.0)
    return k, smoothed, sigma > 0


def _psis_tail_scores(tail_vals, xcutoff, log_ntl, C, S: int, *, exact: bool):
    """GPD fit + smoothing + elpd reductions over the compacted tail.

    Parameters
    ----------
    tail_vals : (B, M) tensor
        Descending shifted top-M values (the cutoff slot excluded).
    xcutoff : (B,) tensor
        ``max((M+1)-th order statistic, log(float64 tiny))``.
    log_ntl : (B,) tensor
        ``log sum_{x <= xcutoff} exp(x)`` over the full shifted row.
    C : (B,) tensor
        Row max of the raw ``x = -log_lik``.
    S : int
        Full row width (draw count).
    exact : bool
        True: rows whose fit gives sigma <= 0 are NaN-poisoned, like the
        reference ``gpinv``.  False: they keep their unsmoothed tail and are
        flagged in ``degenerate``.

    Returns
    -------
    (elpd_i, khat, degenerate) : ((B,), (B,), (B,) bool)
    """
    dtype = tail_vals.dtype
    M = tail_vals.shape[1]
    in_tail = tail_vals > xcutoff[:, None]  # strict, preserves tie semantics
    n_tail = in_tail.sum(dim=1, dtype=torch.int32)
    nf = n_tail.to(dtype)

    # Everything stays in descending layout: the fit takes masked sums plus
    # two order statistics, and the plotting position of descending slot d
    # is (n - d - 0.5)/n.  Within a tie run the reference orders plotting
    # positions by stable argsort, but every sum below is invariant to it.
    slot = torch.arange(M, dtype=torch.int32, device=tail_vals.device)
    slot_valid = slot[None, :] < n_tail[:, None]

    # ascending index q_idx maps to descending index n - 1 - q_idx
    q_idx = torch.clamp((n_tail + 2) // 4 - 1, 0, M - 1)
    q_desc = torch.clamp(n_tail - 1 - q_idx, 0, M - 1).long()[:, None]
    nf_safe = torch.where(nf == 0, 1.0, nf)
    # 1 - p_d == (slot + 0.5)/n exactly, so log1p(-p) = log(slot + 0.5) - log(n);
    # invalid slots keep a p -> 0.5 pin
    log_slot = torch.log(slot.to(dtype) + 0.5)
    log1m_p = torch.where(
        slot_valid,
        log_slot[None, :] - torch.log(nf_safe)[:, None],
        math.log(0.5),
    )

    rows = (tail_vals, xcutoff, slot_valid, n_tail, q_desc, log1m_p)
    if dtype == torch.float64:
        # Deep-tail guard: where a row's quartile exceedance sits below e^-60
        # the rows of its decision group take the signed-log fit, which
        # agrees with the linear one to ~1e-14 where both are defined.  Rows
        # with <= 4 exceedances never smooth.
        q_tail = torch.gather(tail_vals, 1, q_desc)[:, 0]
        log_quart_row = q_tail + _log1mexp(torch.clamp_max(xcutoff - q_tail, 0.0))
        in_range = (n_tail <= 4) | (log_quart_row >= _LINEAR_FIT_MIN_LOG_QUART)
        k, smoothed, sigma_pos = by_branch(
            deep_rows(in_range), _linear_smooth, _log_domain_smooth, *rows
        )
    else:
        k, smoothed, sigma_pos = _log_domain_smooth(*rows)

    would_smooth = (n_tail > 4) & torch.isfinite(k)
    degenerate = would_smooth & ~sigma_pos
    if exact:
        # reference gpinv semantics: sigma <= 0 poisons the row with NaN
        smoothed = torch.where(sigma_pos[:, None], smoothed, math.nan)
        smooth_ok = would_smooth
    else:
        # throughput path: degenerate fits keep the unsmoothed tail
        smooth_ok = would_smooth & sigma_pos
    s_vals = torch.where(smooth_ok[:, None], smoothed, tail_vals)

    # Row reductions in log domain.  The non-tail mass comes summed directly
    # under the x <= xcutoff mask (a subtraction from the full sum would
    # cancel on heavy-tail rows), and the tail ratio sum is max-shifted
    # (exp(s - x) overflows float32 once the cutoff is below ~-88).
    lse_s = logsumexp(torch.where(slot_valid, s_vals, -math.inf), dim=1)
    denom = torch.logaddexp(log_ntl, lse_s)

    d = torch.where(slot_valid, s_vals - tail_vals, -math.inf)
    dm = d.amax(dim=1)
    dms = torch.where(torch.isfinite(dm), dm, 0.0)
    lse_d = dms + torch.log(torch.exp(d - dms[:, None]).sum(dim=1))
    numer = torch.logaddexp(torch.log(S - nf), lse_d)
    elpd_i = -C + numer - denom

    khat = torch.where(n_tail <= 4, math.inf, k)
    return elpd_i, khat, degenerate


def psis_tail_fit_plain(vals, log_ntl, C, S: int):
    """Plain version of kernel F: ``(elpd_i, khat, degenerate)`` from the
    fused prepass's output.

    ``vals`` are the descending shifted top M + 1 of each row (kernel A's or
    ``loo_prepass_multi``'s), ``log_ntl`` its non-tail mass, ``C`` the row
    max of ``x = -log_lik`` and ``S`` the draws a row.  The cutoff is the
    (M+1)-th value floored at log(float64 tiny); then
    :func:`_psis_tail_scores` with ``exact=False``.
    """
    M = vals.shape[1] - 1
    xcutoff = torch.clamp_min(vals[:, M], _CUTOFF_FLOOR)
    # a NaN cutoff (a row of +-inf in x, or a NaN) leaves no element
    # under it: the empty sum _nontail_mass gives, where kernel A's is NaN
    log_ntl = torch.where(torch.isnan(xcutoff), -math.inf, log_ntl)
    return _psis_tail_scores(vals[:, :M], xcutoff, log_ntl, C, S, exact=False)


def _check_tail_fit(vals, log_ntl, C, S: int) -> None:
    if vals.dim() != 2 or vals.shape[1] < 2:
        raise ValueError(f"expected (B, M + 1) tail values, got shape {tuple(vals.shape)}")
    if vals.dtype != torch.float32:
        raise TypeError(f"expected float32, got {vals.dtype}")
    M = vals.shape[1] - 1
    if M > MAX_K - 1 or S < M + 1:
        raise ValueError(f"the kernel does not support M={M}, S={S}"
                         f" (needs M <= {MAX_K - 1} and S >= M + 1)")
    if vals.stride(1) != 1:
        raise ValueError("tail rows must be contiguous (stride 1 along the row)")
    for name, t in (("log_ntl", log_ntl), ("C", C)):
        if t.shape != vals.shape[:1] or t.dtype != vals.dtype or t.device != vals.device:
            raise ValueError(f"{name} must be ({vals.shape[0]},) {vals.dtype} on {vals.device},"
                             f" got {tuple(t.shape)} {t.dtype} on {t.device}")


def psis_tail_fit(vals, log_ntl, C, S: int, route: str = "cuda"):
    """Kernel F: the float32 tail fit, smoothing and elpd reductions of
    :func:`loo_scores_psis_fast` in one launch.

    Takes what :func:`psis_tail_fit_plain` takes (``vals`` may be a view
    with a row stride longer than M + 1) and returns what it returns; on
    the card, the same terms summed in another order.  A CUDA tensor
    launches ``csrc/psis_tail_fit.cu`` on its device and current stream,
    counted in ``launches`` and ``by_device`` and, while a profiler
    records, as B rows under ``route`` in the ``fit_kernel_rows`` counter;
    a CPU tensor takes the plain version.  Raises on what the kernel does
    not take: not float32, a row that is not contiguous, M > 1023.
    """
    _check_tail_fit(vals, log_ntl, C, S)
    if vals.device.type == "cpu":
        return psis_tail_fit_plain(vals, log_ntl, C, S)
    device, ld, stream = _launch_args(vals)
    b = vals.shape[0]
    elpd_i, khat = torch.empty((2, b), dtype=vals.dtype, device=vals.device)
    degenerate = torch.empty(b, dtype=torch.bool, device=vals.device)
    if b == 0:
        return elpd_i, khat, degenerate
    lib = _build.load()
    code = lib.pyloo_psis_tail_fit_f32(
        device, vals.data_ptr(), b, vals.shape[1] - 1, ld, log_ntl.contiguous().data_ptr(),
        C.contiguous().data_ptr(), S, elpd_i.data_ptr(), khat.data_ptr(),
        degenerate.data_ptr(), stream,
    )
    _raise_on(code, lib, "psis_tail_fit")
    psis_tail_fit.launches += 1
    _count_on(psis_tail_fit.by_device, vals.device)
    profiling.count("fit_kernel_rows", route, b)
    return elpd_i, khat, degenerate


psis_tail_fit.launches = 0
psis_tail_fit.by_device = {}


def _nontail_mass(x, xcutoff, m1=None):
    """log sum over {x <= xcutoff} of exp(x), max-shifted (full-row pass).

    ``m1``, the largest element of the masked set, may come from the compact
    selection output (the ``(n_tail+1)``-th order statistic).
    """
    nontail_mask = x <= xcutoff[:, None]
    if m1 is None:
        m1 = torch.where(nontail_mask, x, -math.inf).amax(dim=1)
    m1s = torch.where(torch.isfinite(m1), m1, 0.0)
    return m1s + torch.log(
        torch.where(nontail_mask, torch.exp(x - m1s[:, None]), 0.0).sum(dim=1)
    )


def loo_scores_psis(log_lik, tail_max: int):
    """(B, S) log-lik -> (elpd_i, pareto_k, lppd_i), reference-exact.

    Semantics of reference ``pyloo/psis.py:114-231`` through
    ``pyloo/loo.py:286-337``: strict-``>`` tie membership, float64-tiny cutoff
    floor, NaN poisoning of sigma <= 0 fits.  Selection runs on the unshifted
    rows (it is shift-invariant); the shift ``x - C1`` is applied to the
    compact winners, per element the identical operation.
    """
    x_raw = -log_lik
    S = x_raw.shape[1]
    M = tail_max

    vals_raw = topk_vals_desc(x_raw, M + 1)
    C1 = vals_raw[:, 0]
    vals = vals_raw - C1[:, None]

    xcutoff = torch.clamp_min(vals[:, M], _CUTOFF_FLOOR)
    # the largest non-tail element is the (n_tail+1)-th order statistic
    n_tail = (vals[:, :M] > xcutoff[:, None]).sum(dim=1)
    m1 = torch.gather(vals, 1, n_tail[:, None])[:, 0]
    log_ntl = _nontail_mass(x_raw - C1[:, None], xcutoff, m1)
    # the row minimum is the lppd's max-shift: max(log_lik) == -min(x) exactly
    row_min = x_raw.amin(dim=1)
    ll_max = torch.where(torch.isfinite(row_min), -row_min, 0.0)
    lppd_i = (
        torch.log(torch.exp(log_lik - ll_max[:, None]).sum(dim=1))
        + ll_max
        - math.log(S)
    )
    elpd_i, khat, _ = _psis_tail_scores(vals[:, :M], xcutoff, log_ntl, C1, S, exact=True)
    return elpd_i, khat, lppd_i


def loo_scores_psis_fast(log_lik, tail_max: int, route: str | None = None):
    """Scatter-free PSIS-LOO scores for the float32 path.

    Returns ``(elpd_i, pareto_k, lppd_i, degenerate)``, all ``(B,)``;
    ``degenerate`` flags rows whose float32 fit gave sigma <= 0 and that
    therefore kept their unsmoothed tail (the float64 path NaN-poisons them).

    ``route`` defaults to :func:`~.selection.fast_path_route`: the fused
    prepass (kernel A, in one pass or split over the draws) on a CUDA
    float32 tensor, else plain torch selection and reductions.  Passing
    ``"torch"`` runs the plain scorer on any device, through no kernel of
    this package (the reference a run on the card is checked against);
    passing ``"cuda"`` on a CPU tensor runs the fused branch over the
    prepass's plain version.  The routes agree on every row, NaN and +-inf
    draws included: a NaN draw makes the row's elpd and lppd NaN and its k
    inf (no tail is fitted).
    """
    x_raw = -log_lik
    S = x_raw.shape[1]
    M = tail_max
    k = M + 1
    if route is None:
        route = fast_path_route(S, k, x_raw.dtype, x_raw.device)

    if route == "cuda":
        vals, C1, log_ntl, log_sum_ll = loo_prepass(x_raw, k)
    elif route == "cuda-multipass":
        vals, C1, log_ntl, log_sum_ll = loo_prepass_multi(
            x_raw, k, parts=multipass_parts(S, k)
        )
    elif route == "torch":
        C1 = x_raw.amax(dim=1)
        x = x_raw - C1[:, None]
        vals = topk_desc_plain(x, k)  # never kernel B: this is the reference
    else:
        raise ValueError(f"unknown route {route!r}")

    if route == "torch":
        xcutoff = torch.clamp_min(vals[:, M], _CUTOFF_FLOOR)
        elpd_i, khat, degenerate = _psis_tail_scores(
            vals[:, :M], xcutoff, _nontail_mass(x, xcutoff), C1, S, exact=False
        )
    else:
        elpd_i, khat, degenerate = psis_tail_fit(vals, log_ntl, C1, S, route)

    if route == "torch":
        lppd_i = logsumexp(log_lik, dim=1, b_inv=S)
    else:
        # kernel A leaves log_lik = +inf draws out of its sum (the TPU
        # kernel's -inf padding) and gives NaN for a row of -inf: where the
        # row's largest log_lik is infinite, the logsumexp is that value
        ll_max = log_lik.amax(dim=1)
        lppd_i = torch.where(torch.isinf(ll_max), ll_max, log_sum_ll - math.log(S))
    return elpd_i, khat, lppd_i, degenerate


def loo_scores_sis(log_lik):
    S = log_lik.shape[1]
    lw, ess = sislw_batch(-log_lik)
    elpd_i = logsumexp(lw + log_lik, dim=1)
    lppd_i = logsumexp(log_lik, dim=1, b_inv=S)
    return elpd_i, ess, lppd_i


def loo_scores_tis(log_lik):
    S = log_lik.shape[1]
    lw, ess = tislw_batch(-log_lik)
    elpd_i = logsumexp(lw + log_lik, dim=1)
    lppd_i = logsumexp(log_lik, dim=1, b_inv=S)
    return elpd_i, ess, lppd_i


def mixture_scores(log_lik):
    """Mix-IS-LOO elpd per observation (Silva & Zanella 2022, App. A.2).

    Reference ``pyloo/loo.py:252-284``: with per-observation mixture constant
    c_i = logsumexp_s(-ll_is), elpd_i = logsumexp_i(-c_i) -
    logsumexp_s(-ll_is - c_i).
    """
    S = log_lik.shape[1]
    c = logsumexp(-log_lik, dim=1)  # per observation, (B,)
    log_norm = logsumexp(-c, dim=0)  # global over observations
    log_obs = logsumexp(-log_lik - c[:, None], dim=1)
    elpd_i = log_norm - log_obs
    lppd_i = logsumexp(log_lik, dim=1, b_inv=S)
    return elpd_i, lppd_i


def waic_scores(log_lik):
    """(B, S) log-lik -> (lppd_i, p_waic_i) for WAIC (reference waic.py:137-146).

    The reference takes the population variance over draws (ddof = 0).
    """
    S = log_lik.shape[1]
    lppd_i = logsumexp(log_lik, dim=1, b_inv=S)
    p_waic_i = torch.var(log_lik, dim=1, correction=0)
    return lppd_i, p_waic_i
