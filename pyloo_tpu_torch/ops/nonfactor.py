"""Conditional log-likelihoods of non-factorised MVN / MVT models.

Counterpart of ``pyloo_tpu/ops/nonfactor.py``: the draws are a batch axis,
and the Student-t quadratic form uses the rank-1 identity

    beta_{-i} = (y-mu)^T P (y-mu) - g_i^2 / P_ii,   g = P (y-mu)

(from Proposition 3 of Bürkner, Gabry & Vehtari 2021).  A covariance goes
through a batched Cholesky factorisation, ``cov = L L^T`` and
``Linv = L^{-1}`` (a triangular solve against the identity):

    g      = Linv^T (Linv r)
    P_ii   = sum_k Linv[k, i]^2
    r^T P r = || Linv r ||^2

``torch.linalg.cholesky_ex`` reports a matrix that is not positive definite
by its ``info``; such a draw's row is ``-inf``, which is what ``pyloo_tpu``
gets from the NaN factor ``jnp.linalg.cholesky`` returns.

The draws go through in chunks whose matrices fit ``_CHUNK_BUDGET_BYTES`` of
device memory (the chunk's matrices on the device, its factor and its
inverse factor, and a temporary of the solve), so an ``(S, N, N)`` input
that lies on the host is copied to the device one chunk at a time; each
draw is independent, so chunking changes no value.  Over a mesh
(:class:`pyloo_tpu_torch.parallel.Mesh`) the chunks are dealt over its
devices in turn, each factorising its own: the draw axis is sharded, as
``pyloo_tpu`` shards it, and every draw's row is the same computation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._common import compute_device
from ..parallel.sharding import device_scope

__all__ = ["mvn_conditional_loglik", "mvt_conditional_loglik", "draws_per_chunk"]

# Device memory for one chunk of draws: _MATRICES_PER_DRAW (N, N) float64
# matrices a draw
_CHUNK_BUDGET_BYTES = 1 << 30
_MATRICES_PER_DRAW = 4


def draws_per_chunk(n: int) -> int:
    """Draws of ``n x n`` float64 matrices that one chunk holds."""
    return max(1, _CHUNK_BUDGET_BYTES // (_MATRICES_PER_DRAW * 8 * n * n))


def _as_device(x, device):
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float64).to(device)


def _precision_terms(y, mu, cov=None, prec=None):
    """``g = P r``, ``diag(P)``, ``r^T P r`` and the failed factorisations
    of one chunk of draws (device tensors)."""
    r = y[None, :] - mu  # (S, N)
    if prec is not None:
        g = torch.einsum("sij,sj->si", prec, r)
        cbar = torch.diagonal(prec, dim1=1, dim2=2)
        quad = torch.einsum("si,si->s", r, g)
        return g, cbar, quad, None
    chol, info = torch.linalg.cholesky_ex(cov)
    failed = info != 0
    eye = torch.eye(r.shape[1], dtype=r.dtype, device=r.device)
    linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
    lr = torch.einsum("sij,sj->si", linv, r)  # L^{-1} r
    g = torch.einsum("ski,sk->si", linv, lr)  # L^{-T} L^{-1} r = P r
    cbar = torch.einsum("ski,ski->si", linv, linv)  # diag(P)
    quad = torch.einsum("si,si->s", lr, lr)  # ||L^{-1} r||^2 = r^T P r
    return g, cbar, quad, failed


def _mvn_chunk(y, mu, cov=None, prec=None):
    g, cbar, _, failed = _precision_terms(y, mu, cov, prec)
    eps = torch.finfo(g.dtype).eps
    bad = ~(cbar > 0)  # catches NaN as well as non-positive diagonals
    cbar_safe = torch.where(bad, eps, cbar)
    ll = -0.5 * math.log(2 * math.pi) + 0.5 * torch.log(cbar_safe) - 0.5 * g**2 / cbar_safe
    ll = torch.where(bad, -math.inf, ll)
    # a non-finite entry anywhere in g marks the draw's row
    row_ok = torch.all(torch.isfinite(g) | bad, dim=1, keepdim=True)
    if failed is not None:
        row_ok = row_ok & ~failed[:, None]
    return torch.where(row_ok, ll, -math.inf)


def _mvt_chunk(y, mu, df, cov=None, prec=None):
    N = y.shape[0]
    g, cbar, quad, failed = _precision_terms(y, mu, cov, prec)
    eps = torch.finfo(g.dtype).eps
    bad = ~(cbar > 0)
    cbar_safe = torch.where(bad, eps, cbar)

    beta = quad[:, None] - g**2 / cbar_safe  # (S, N) rank-1 identity
    df = df[:, None]
    cond_df = df + N - 1
    resid = g / cbar_safe  # y_i - cond_loc
    cond_scale = (df + beta) / (df + N - 1) / cbar_safe

    ll = (
        torch.lgamma((cond_df + 1) / 2)
        - torch.lgamma(cond_df / 2)
        - 0.5 * torch.log(cond_df * math.pi * cond_scale)
        - ((cond_df + 1) / 2) * torch.log1p(resid**2 / (cond_scale * cond_df))
    )
    invalid = (
        bad
        | ~torch.isfinite(beta)
        | ~(cond_scale > 0)
        | (df <= 0)
        | ~torch.isfinite(g)
    )
    if failed is not None:
        invalid = invalid | failed[:, None]
    return torch.where(invalid, -math.inf, ll)


def _by_chunks(fn, y, mu, per_draw: tuple, matrix, mesh=None):
    """``fn`` over chunks of draws; ``per_draw`` are further (S, ...) inputs
    and ``matrix`` the (S, N, N) one.  Over ``mesh`` chunk ``i`` runs on its
    device ``i % mesh.size``.  Returns the (S, N) result on the computation
    device."""
    device = compute_device()
    devices = mesh.devices if mesh is not None else (device,)
    ys = {str(d): _as_device(y, d) for d in devices}
    S, N = mu.shape[0], ys[str(devices[0])].shape[0]
    chunk = draws_per_chunk(N)
    out = torch.empty((S, N), dtype=torch.float64, device=device)
    for i, start in enumerate(range(0, S, chunk)):
        sl = slice(start, min(start + chunk, S))
        on = devices[i % len(devices)]
        with device_scope(on):
            args = [_as_device(a[sl], on) for a in (mu,) + per_draw + (matrix,)]
            out[sl] = fn(ys[str(on)], *args)
            del args
    return out


def mvn_conditional_loglik(y, mu, cov=None, prec=None, *, mesh=None):
    """(S, N) conditional leave-one-out log-densities for a joint MVN.

    log p(y_i | y_-i, theta_s) = -0.5 log 2pi + 0.5 log Pbar_ii
    - 0.5 g_i^2 / Pbar_ii.  A covariance draw that is not positive definite
    gives a ``-inf`` row.  ``y`` is (N,), ``mu`` (S, N) and ``cov`` or
    ``prec`` (S, N, N), numpy arrays or tensors; the result is a tensor on
    ``rcParams["device.device"]``.  ``mesh`` deals the chunks of draws
    over its devices.
    """
    if cov is not None:
        return _by_chunks(lambda y, m, c: _mvn_chunk(y, m, cov=c), y, mu, (), cov, mesh)
    return _by_chunks(lambda y, m, p: _mvn_chunk(y, m, prec=p), y, mu, (), prec, mesh)


def mvt_conditional_loglik(y, mu, df, cov=None, prec=None, *, mesh=None):
    """(S, N) conditional LOO log-densities for a joint multivariate-t.

    The conditional is a Student-t with df+N-1 degrees of freedom, location
    y_i - g_i/Pbar_ii and scale^2 (df + beta_-i)/(df+N-1)/Pbar_ii.  ``df``
    is (S,); draws with ``df <= 0`` give ``-inf`` rows.  Inputs, result and
    ``mesh`` as in :func:`mvn_conditional_loglik`.
    """
    if cov is not None:
        return _by_chunks(lambda y, m, d, c: _mvt_chunk(y, m, d, cov=c), y, mu, (df,), cov,
                          mesh)
    return _by_chunks(lambda y, m, d, p: _mvt_chunk(y, m, d, prec=p), y, mu, (df,), prec,
                      mesh)
