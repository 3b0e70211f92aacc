"""The benchmark's plain torch reference: PSIS-LOO of many rows at once.

The same mathematics as :mod:`benchmark.reference` (PSIS after Vehtari et
al. 2024 with the Zhang-Stephens GPD fit), written with whole-row torch
operations so that every row of a cell can be scored again after its
window.  It computes in the dtype it is given: float64 is the reference,
a lower dtype is the control that the comparison has to fail.  A tie at the
cutoff shortens a row's tail, as in the one-row reference: each row's fit
runs over its own count of values, masked.  It imports torch and numpy
only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LOG_TINY = math.log(np.finfo(np.float64).tiny)


def lpd(ll: torch.Tensor) -> torch.Tensor:
    """Log pointwise predictive density of each row: logsumexp - log S."""
    return torch.logsumexp(ll, dim=1) - math.log(ll.shape[1])


def fit_gpd(y: torch.Tensor, valid: torch.Tensor):
    """Zhang-Stephens (k, sigma) of each row's ascending exceedances: the
    last ``n`` entries of ``y`` (B, width) where ``valid`` (a suffix of each
    row) holds, ``n`` at least 1; with the weakly informative prior
    shrinking k towards 0.5."""
    dtype, width = y.dtype, y.shape[1]
    n = valid.sum(dim=1, keepdim=True)  # (B, 1)
    nf = n.to(dtype)
    n_grid = 30 + torch.floor(torch.sqrt(nf))  # (B, 1)
    j = torch.arange(1, 31 + int(math.floor(math.sqrt(width))), dtype=dtype, device=y.device)
    on_grid = j[None] <= n_grid  # (B, G)
    first = width - n  # (B, 1): the position of each row's smallest exceedance
    quartile = y.gather(1, first + torch.floor(nf / 4.0 + 0.5).long() - 1)
    theta = 1.0 / y[:, -1:] + (1.0 - torch.sqrt(n_grid / (j[None] - 0.5))) / (3.0 * quartile)
    theta = torch.where(on_grid, theta, -1.0)
    terms = torch.log1p(-theta[:, :, None] * y[:, None, :])
    k_of_theta = torch.where(valid[:, None, :], terms, 0.0).sum(dim=2) / nf
    ell = torch.where(on_grid, nf * (torch.log(-theta / k_of_theta) - k_of_theta - 1.0),
                      -math.inf)
    post = torch.exp(ell - ell.amax(dim=1, keepdim=True))
    post = post / post.sum(dim=1, keepdim=True)
    post = torch.where(post < 10 * torch.finfo(dtype).eps, 0.0, post)
    post = post / post.sum(dim=1, keepdim=True)
    theta_hat = torch.where(on_grid, theta * post, 0.0).sum(dim=1, keepdim=True)
    k_hat = torch.where(valid, torch.log1p(-theta_hat * y), 0.0).sum(dim=1) / nf[:, 0]
    sigma = -k_hat / theta_hat[:, 0]
    return (nf[:, 0] * k_hat + 5.0) / (nf[:, 0] + 10.0), sigma


def gpd_quantile(p: torch.Tensor, k: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """GPD quantiles at probabilities ``p`` (B, n) for each row's (k, sigma)."""
    k, sigma = k[:, None], sigma[:, None]
    log1m = torch.log1p(-p)
    small = k.abs() < torch.finfo(k.dtype).eps
    q = torch.where(small, -sigma * log1m, sigma * torch.expm1(-k * log1m) / torch.where(
        small, 1.0, k))
    return torch.where(sigma <= 0, math.nan, q)


def psis_loo(ll: torch.Tensor, tail: int):
    """(loo_i, k, lpd_i) of each row of ``ll`` (B, S), in its dtype.  The
    tail is the values of ``-ll`` strictly above the ``tail + 1``-th
    largest (floored at log float64 tiny); a row with 4 or fewer of them
    takes k = inf and no smoothing."""
    lw = -ll
    lw = lw - lw.amax(dim=1, keepdim=True)
    vals, idx = torch.topk(lw, tail + 1, dim=1)  # descending
    cut = vals[:, tail].clamp_min(LOG_TINY)
    top, idx = vals[:, :tail].flip(1), idx[:, :tail].flip(1)  # ascending
    valid = top > cut[:, None]  # a suffix of each row
    n = valid.sum(dim=1)
    fitted = n > 4
    y = top.exp() - cut.exp()[:, None]
    k, sigma = fit_gpd(torch.where(valid, y, 1.0), valid | ~fitted[:, None])
    k = torch.where(fitted, k, math.inf)
    pos = torch.arange(tail, device=ll.device)[None] - (tail - n)[:, None]
    p = (pos.to(ll.dtype) + 0.5) / n.clamp_min(1)[:, None].to(ll.dtype)
    smoothed = torch.log(gpd_quantile(p.clamp(0.0, 1.0), k, sigma) + cut.exp()[:, None])
    smooth = (valid & torch.isfinite(k)[:, None])
    lw = lw.scatter(1, idx, torch.where(smooth, smoothed, top))
    lw = torch.where(torch.isfinite(k)[:, None], lw.clamp_max(0.0), lw)
    lw = lw - torch.logsumexp(lw, dim=1, keepdim=True)
    return torch.logsumexp(lw + ll, dim=1), k, lpd(ll)


class Totals:
    """Running sums over the rows scored finite: elpd, its square, lppd, and
    their count (a row that is not is the comparison's mismatch to count)."""

    def __init__(self):
        self.parts = {"e": [], "e2": [], "lppd": [], "n": []}

    def add(self, loo_i: torch.Tensor, lpd_i: torch.Tensor) -> None:
        finite = torch.isfinite(loo_i) & torch.isfinite(lpd_i)
        e = torch.where(finite, loo_i.double(), 0.0)
        self.parts["e"].append(e.sum())
        self.parts["e2"].append((e * e).sum())
        self.parts["lppd"].append(torch.where(finite, lpd_i.double(), 0.0).sum())
        self.parts["n"].append(finite.sum())

    def result(self) -> dict:
        """``elpd_loo``, ``p_loo`` and ``se`` as ``loo`` reports them: se the
        square root of n times the population variance of loo_i."""
        s = {key: math.fsum(v.item() for v in vals) for key, vals in self.parts.items()}
        n = s["n"]
        var = max(s["e2"] / n - (s["e"] / n) ** 2, 0.0)
        return {"elpd_loo": s["e"], "p_loo": s["lppd"] - s["e"], "se": math.sqrt(n * var)}


def score_rows(ll: torch.Tensor, tail: int, dtype: torch.dtype, block: int = 8192):
    """loo_i, k and lpd_i (float64 tensors on ``ll``'s device) of every row of
    ``ll`` scored in ``dtype``, ``block`` rows at a time."""
    out = [psis_loo(ll[start:start + block].to(dtype), tail)
           for start in range(0, ll.shape[0], block)]
    return tuple(torch.cat([o[i] for o in out]).double() for i in range(3))
