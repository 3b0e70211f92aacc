"""The benchmark's plain moment matching of the Poisson GLMM, a lane at a time.

Implicitly adaptive importance sampling after Paananen, Piironen, Bürkner
and Vehtari (2021, Stat. Comput. 31, arXiv:1906.08850), as R ``loo``'s
``loo_moment_match`` runs it with ``split = TRUE``, ``cov = TRUE`` and
``max_iters = 30``, written again in plain torch, one flagged observation
(a *lane*) at a time, in the dtype it is given: float64 is the reference,
float32 (one precision below) the control that the comparison has to fail.
It imports torch, numpy and the benchmark's own plain PSIS and ESS
(:mod:`benchmark.reference_torch`, :mod:`benchmark.reference`), nothing of
the program under test, and sets TF32 off.

1. Every row's first PSIS-LOO, with the tail length of the posterior's
   relative efficiency (the mean split-chain ESS of every parameter over
   S); a row whose k exceeds ``min(1 - 1 / log10 S, 0.7)`` is a lane.
2. A lane's tail length comes from the relative efficiency of its
   log-likelihood at the draws, and its weights from PSIS of ``-log_lik``;
   its baseline k is its first PSIS k.
3. Passes of the greedy loop: shift (the weighted mean), then shift and
   scale (the weighted marginal variances), then shift and covariance (the
   map ``L_w L^-1`` of the weighted and plain covariances' Cholesky
   factors; the identity where a factorisation fails), each computed from
   the current draws and accepted only if the PSIS k of the ratios
   ``-log_lik + log p(new) - log p(draws)`` is strictly lower.  A lane
   stops after a pass that accepts nothing, once k is at most the
   threshold, or once 30 transforms are accepted; the transforms of one
   pass are all tried, so a pass may take it to 32 (pyloo's order, which
   the program follows: R's loop starts again from the shift after each
   accepted transform).
4. After a pass that accepted something, the split transform: the first
   S / 2 draws mapped forward by the accepted transforms, the last S / 2
   backward, and the weights of the two halves' deterministic mixture,
   smoothed with the lane's tail length.
5. The lane's ``loo_i`` is ``log sum exp(log_lik + lw)`` at the final
   draws, its k the greedy loop's last, and its ``p_loo_i`` the log mean
   likelihood there less ``loo_i``.  ``elpd_loo`` is the sum of ``loo_i``,
   ``se`` the square root of N times their population variance and
   ``p_loo`` the sum of the lanes' ``p_loo_i`` (pyloo's update, which the
   program follows: a row that is no lane adds 0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import reference, reference_torch

N_FIXED = 5  # the flat vector's fixed effects before the patient intercepts
SHIFT, SCALE, COV = 0, 1, 2


class Density:
    """The GLMM's log-likelihood and log joint density of draws ``u`` (B,
    P), in ``dtype``, written from its data: ``eta = b0 + x . b + a_j``,
    ``y eta - exp(eta) - log y!``, and the normal priors of ``b`` (sds
    ``prior_sd``) and of the intercepts (sd ``tau``)."""

    def __init__(self, x, y, patient, prior_sd, tau: float, dtype):
        self.x, self.y = x.to(dtype), y.to(dtype)
        self.patient = patient
        self.lgy = torch.lgamma(y.double() + 1.0).to(dtype)
        self.prior_sd = torch.as_tensor(prior_sd, dtype=dtype, device=x.device)
        self.tau = tau

    def log_lik_rows(self, u: torch.Tensor) -> torch.Tensor:
        """(B, N): every observation's log-likelihood at each draw."""
        eta = u[:, :1] + u[:, 1:N_FIXED] @ self.x.T + u[:, N_FIXED:][:, self.patient]
        return self.y * eta - torch.exp(eta) - self.lgy

    def log_lik_row(self, u: torch.Tensor, i: int) -> torch.Tensor:
        """(B,): observation ``i``'s log-likelihood at each draw."""
        eta = (u[:, 0] + u[:, 1:N_FIXED] @ self.x[i]
               + u[:, N_FIXED + int(self.patient[i])])
        return self.y[i] * eta - torch.exp(eta) - self.lgy[i]

    def log_prob(self, u: torch.Tensor) -> torch.Tensor:
        """(B,): the log joint density, the priors' constants left out."""
        b, a = u[:, :N_FIXED], u[:, N_FIXED:]
        prior = (-0.5 * torch.sum((b / self.prior_sd) ** 2, dim=1)
                 - 0.5 * torch.sum(a * a, dim=1) / (self.tau * self.tau))
        return prior + torch.sum(self.log_lik_rows(u), dim=1)


def psislw(lr: torch.Tensor, tail: int):
    """(smoothed normalised log weights, k) of one row of raw log ratios
    ``lr`` (S,), with a tail of ``tail`` draws: :func:`benchmark.
    reference_torch.psis_loo`'s smoothing, returning the weights."""
    lw = (lr - lr.max())[None]
    vals, idx = torch.topk(lw, tail + 1, dim=1)
    cut = vals[:, tail].clamp_min(reference_torch.LOG_TINY)
    top, idx = vals[:, :tail].flip(1), idx[:, :tail].flip(1)  # ascending
    valid = top > cut[:, None]
    n = valid.sum(dim=1)
    fitted = n > 4
    y = top.exp() - cut.exp()[:, None]
    k, sigma = reference_torch.fit_gpd(torch.where(valid, y, 1.0), valid | ~fitted[:, None])
    k = torch.where(fitted, k, math.inf)
    pos = torch.arange(tail, device=lr.device)[None] - (tail - n)[:, None]
    p = (pos.to(lr.dtype) + 0.5) / n.clamp_min(1)[:, None].to(lr.dtype)
    smoothed = torch.log(reference_torch.gpd_quantile(p.clamp(0.0, 1.0), k, sigma)
                         + cut.exp()[:, None])
    smooth = valid & torch.isfinite(k)[:, None]
    lw = lw.scatter(1, idx, torch.where(smooth, smoothed, top))
    lw = torch.where(torch.isfinite(k)[:, None], lw.clamp_max(0.0), lw)
    return (lw - torch.logsumexp(lw, dim=1, keepdim=True))[0], float(k[0])


def transform(u: torch.Tensor, lw: torch.Tensor, kind: int):
    """(new draws, shift, scaling, mapping) of one moment-matching transform
    of draws ``u`` (S, P) under normalised log weights ``lw``."""
    S, P = u.shape
    w = torch.exp(lw)
    mean = u.mean(dim=0)
    mean_w = w @ u
    shift = mean_w - mean
    ones = torch.ones(P, dtype=u.dtype, device=u.device)
    eye = torch.eye(P, dtype=u.dtype, device=u.device)
    if kind == SHIFT:
        return u + shift, shift, ones, eye
    centred = u - mean
    if kind == SCALE:
        var_w = (w @ (u * u) - mean_w * mean_w) * S / (S - 1)
        scaling = torch.sqrt(var_w / torch.mean(centred * centred, dim=0))
        return centred * scaling + mean_w, shift, scaling, eye
    cov = centred.T @ centred / (S - 1)
    centred_w = u - (w @ u) / w.sum()
    cov_w = (w[:, None] * centred_w).T @ centred_w / (w.sum() - (w @ w) / w.sum())
    chol_w, info_w = torch.linalg.cholesky_ex(cov_w)
    chol, info = torch.linalg.cholesky_ex(cov)
    mapping = torch.linalg.solve_triangular(chol, chol_w, upper=False, left=False)
    if int(info_w) != 0 or int(info) != 0 or not bool(torch.isfinite(mapping).all()):
        mapping = eye
    return centred @ mapping.T + mean_w, shift, ones, mapping


def split_weights(density: Density, u, i: int, shift, scaling, mapping, tail: int):
    """(log_lik, smoothed log weights) of lane ``i`` under the split
    transform of the draws ``u``."""
    S = u.shape[0]
    half = S // 2
    mean = u.mean(dim=0)
    centred = u - mean
    forward = (centred * scaling) @ mapping.T + shift + mean
    backward = (centred @ torch.linalg.inv(mapping).T) / scaling + mean - shift
    u_fwd = torch.cat([forward[:half], u[half:]])
    u_inv = torch.cat([u[:half], backward[half:]])
    lp_fwd, lp_inv = density.log_prob(u_fwd), density.log_prob(u_inv)
    ll = density.log_lik_row(u_fwd, i)
    log_jac = torch.log(scaling).sum() + torch.linalg.slogdet(mapping)[1]
    lr = -ll + lp_fwd - torch.logaddexp(lp_fwd, lp_inv - log_jac)
    lr = torch.where(torch.isnan(lr) | (lr == math.inf), -math.inf, lr)
    return ll, psislw(lr, tail)[0]


def match_lane(density: Density, u, lp0, i: int, k0: float, chains: int, k_threshold: float,
               max_iters: int, np_dtype, split: bool = True):
    """(loo_i, k, p_loo_i, accepted transforms, passes, tail length) of lane
    ``i`` from the draws ``u`` (S, P), their log density ``lp0`` and its
    first PSIS k ``k0``."""
    S = u.shape[0]
    ll = density.log_lik_row(u, i)
    reff = reference.ess_mean(ll.cpu().numpy().astype(np_dtype).reshape(chains, -1),
                              np_dtype) / S
    tail = reference.tail_length(S, float(reff))
    lw, _ = psislw(-ll, tail)
    k, accepted, passes = k0, 0, 0
    total_shift = torch.zeros_like(u[0])
    total_scaling = torch.ones_like(u[0])
    total_mapping = torch.eye(u.shape[1], dtype=u.dtype, device=u.device)
    draws = u
    while accepted + 1 <= max_iters and k > k_threshold:
        passes += 1
        progressed = False
        for kind in (SHIFT, SCALE, COV):
            new, shift, scaling, mapping = transform(draws, lw, kind)
            lp = density.log_prob(new)
            ll_new = density.log_lik_row(new, i)
            lr = -ll_new + lp - lp0
            lr = torch.where(torch.isnan(lr), -math.inf, lr)
            lw_new, k_new = psislw(lr, tail)
            if k_new < k:
                draws, lw, k, ll = new, lw_new, k_new, ll_new
                total_shift = total_shift + shift
                total_scaling = total_scaling * scaling
                total_mapping = mapping @ total_mapping
                accepted += 1
                progressed = True
        if not progressed:
            break
    if split and accepted:
        ll, lw = split_weights(density, u, i, total_shift, total_scaling, total_mapping, tail)
    loo_i = float(torch.logsumexp(ll + lw, dim=0))
    lpd_i = float(torch.logsumexp(ll, dim=0)) - math.log(S)
    return loo_i, k, lpd_i - loo_i, accepted, passes, tail


def loo_moment_match(data: dict, flat, tau: float, prior_sd, dtype=torch.float64,
                     max_iters: int = 30, split: bool = True) -> dict:
    """``loo_i``, ``k``, ``accepted`` (each row's accepted transforms, -1
    for a row that is no lane), ``passes`` (the greedy loop's passes of each
    lane, 0 elsewhere) and ``tail`` (each lane's tail length, 0 elsewhere),
    host arrays, and ``elpd_loo``, ``p_loo``, ``se`` of the GLMM with data
    ``x``, ``y``, ``patient`` (tensors on one device) and draws ``flat``
    (chains, draws, P), computed in ``dtype``; with ``split`` False a
    lane's weights are those of its last accepted transform."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    x, y, patient = data["x"], data["y"], data["patient"]
    flat = torch.as_tensor(flat)
    chains, draws, n_params = flat.shape
    S = chains * draws
    density = Density(x, y, patient, prior_sd, tau, dtype)
    u = flat.reshape(S, n_params).to(device=x.device, dtype=dtype)
    host = flat.cpu().numpy().astype(np_dtype)
    reff = reference.relative_eff({"b": host[..., :N_FIXED], "a": host[..., N_FIXED:]},
                                  np_dtype)
    rows = density.log_lik_rows(u).T.contiguous()  # (N, S)
    loo_i, k, _ = reference_torch.score_rows(rows, reference.tail_length(S, reff), dtype)
    loo_i, k = loo_i.cpu().numpy(), k.cpu().numpy()
    del rows
    k_threshold = min(1.0 - 1.0 / math.log10(S), 0.7)
    lp0 = density.log_prob(u)
    accepted = np.full(loo_i.shape, -1, np.int64)
    passes, tails = np.zeros(loo_i.shape, np.int64), np.zeros(loo_i.shape, np.int64)
    p_loo_i = np.zeros(loo_i.shape)
    for i in np.nonzero(k > k_threshold)[0].tolist():
        loo_i[i], k[i], p_loo_i[i], accepted[i], passes[i], tails[i] = match_lane(
            density, u, lp0, i, float(k[i]), chains, k_threshold, max_iters, np_dtype, split)
    return {"loo_i": loo_i, "k": np.asarray(k, np.float64), "accepted": accepted,
            "passes": passes, "tail": tails,
            "elpd_loo": float(np.sum(loo_i)), "p_loo": float(np.sum(p_loo_i)),
            "se": float(math.sqrt(loo_i.size * np.var(loo_i)))}
