"""Conditional log-likelihoods of non-factorised MVN / MVT models.

Counterpart of ``pyloo_tpu/ops/nonfactor.py``: the draws are a batch axis,
and the Student-t quadratic form uses the rank-1 identity

    beta_{-i} = (y-mu)^T P (y-mu) - g_i^2 / P_ii,   g = P (y-mu)

(from Proposition 3 of Bürkner, Gabry & Vehtari 2021).  A covariance goes
through a batched Cholesky factorisation, ``cov = L L^T`` and
``Linv = L^{-1}`` (:func:`_tri_inverse`):

    g      = Linv^T (Linv r)
    P_ii   = sum_k Linv[k, i]^2
    r^T P r = || Linv r ||^2

``torch.linalg.cholesky_ex`` reports a matrix that is not positive definite
by its ``info``; such a draw's row is ``-inf``, which is what ``pyloo_tpu``
gets from the NaN factor ``jnp.linalg.cholesky`` returns.

On a card the inverse factor of N > 256 is merged from the inverses of
its diagonal blocks by batched matrix products (:func:`_merged_inverse`):
``2 N³ / 3`` flops on the tensor cores, where a triangular solve against
the identity does ``N³`` in ~120 launches a chunk of eight 2,048 x 2,048
matrices.  On the CPU the solve is the faster (:func:`_tri_inverse`).

The draws go through in chunks whose matrices fit ``_CHUNK_BUDGET_BYTES`` of
device memory (the chunk's matrices on the device, its factor and its
inverse factor, and a temporary of the solve).  A chunk's matrices come
from a chunk source: a slice of an ``(S, N, N)`` array, copied to the
device one chunk at a time when it lies on the host, or a function of the
chunk's draw indices that makes them on the device
(:func:`pyloo_tpu_torch.loo_nonfactor_streaming`).  Each draw is
independent, so chunking changes no value: the chunks make each draw's
``g``, ``P_ii`` and ``r^T P r``, and the densities are computed once from
all of them.  Over a mesh
(:class:`pyloo_tpu_torch.parallel.Mesh`) the chunks are dealt over its
devices in turn, each factorising its own: the draw axis is sharded, as
``pyloo_tpu`` shards it, and every draw's row is the same computation.

Each chunk is two spans, ``pyloo.draws.generate`` (the source's chunk) and
``pyloo.draws.factor`` (queueing the factorisation, the inverse and the
terms), with the chunk ``c`` and the shard ``j``; the counters
``factor_draws`` (by form) and ``h2d_bytes`` (kind ``draws``: the bytes of
a chunk's inputs that start in host memory) record while a profiler does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._common import compute_device
from ..parallel.sharding import device_scope
from ..profiling import count, span

__all__ = ["mvn_conditional_loglik", "mvt_conditional_loglik", "conditional_loglik",
           "draws_per_chunk"]

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


def _draws_to(x, device):
    """A chunk of a per-draw input as a float64 tensor on ``device``; the
    bytes of an array, or of a host tensor bound for a card, counted."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
        count("h2d_bytes", "draws", x.numel() * x.element_size())
    elif x.device.type == "cpu" and device.type != "cpu":
        count("h2d_bytes", "draws", x.numel() * x.element_size())
    return x.to(device, torch.float64)


# the order of the diagonal blocks :func:`_merged_inverse` inverts by a
# triangular solve; a larger factor's inverse is merged from them
_LEAF = 256


def _solve_inverse(chol):
    """``L^{-1}`` by a triangular solve against the identity."""
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    return torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)


def _blocks(t, w: int):
    """The ``(B, n // w, w, w)`` view of the whole ``w x w`` diagonal blocks
    of ``t`` (B, n, n), in any layout."""
    b, rs, cs = t.stride()
    return t.as_strided((t.shape[0], t.shape[1] // w, w, w), (b, w * (rs + cs), rs, cs),
                        t.storage_offset())


def _merge(chol, out, lo: int, hi: int) -> None:
    """Fill ``out[lo:hi, lo:hi]`` below its inverted diagonal ``_LEAF``
    blocks: split at the first multiple of ``_LEAF`` at or past the middle,
    each half merged so, and the block below them
    ``[[A, 0], [B, C]]^{-1} = [[A^{-1}, 0], [-C^{-1} B A^{-1}, C^{-1}]]``."""
    if hi - lo <= _LEAF:
        return
    mid = lo + _LEAF * ((hi - lo + 2 * _LEAF - 1) // (2 * _LEAF))
    _merge(chol, out, lo, mid)
    _merge(chol, out, mid, hi)
    out[:, mid:hi, lo:mid] = torch.bmm(torch.bmm(out[:, mid:hi, mid:hi], chol[:, mid:hi, lo:mid]),
                                       out[:, lo:mid, lo:mid]).neg_()


def _merged_inverse(chol):
    """``L^{-1}`` of a batch of lower-triangular factors ``(B, n, n)``:
    every whole diagonal ``_LEAF`` block inverted by one batched triangular
    solve (a call's time hardly grows with its batch on a card), the ragged
    last block by another, and the rest merged from them by batched
    products (:func:`_merge`): ``2 n³ / 3`` flops in all, with no
    padding."""
    n = chol.shape[-1]
    if n <= _LEAF:
        return _solve_inverse(chol)
    out = chol.new_zeros(chol.shape).mT  # column-major, as the solve's: the terms read it as is
    diag = _blocks(out, _LEAF)
    diag.copy_(_solve_inverse(_blocks(chol, _LEAF).reshape(-1, _LEAF, _LEAF)).view(diag.shape))
    edge = n - n % _LEAF
    if edge < n:
        out[:, edge:, edge:] = _solve_inverse(chol[:, edge:, edge:])
    _merge(chol, out, 0, n)
    return out


def _tri_inverse(chol):
    """``L^{-1}``: merged from blocks on a card (:func:`_merged_inverse`),
    where the triangular solve is launch bound, by the solve elsewhere,
    where it is the faster up to N = 2,100 at least."""
    return _merged_inverse(chol) if chol.is_cuda else _solve_inverse(chol)


def _precision_terms(y, mu, cov=None, prec=None):
    """``g = P r``, ``diag(P)``, ``r^T P r`` and the failed factorisations
    of one chunk of draws (device tensors)."""
    r = y[None, :] - mu  # (S, N)
    count("factor_draws", "cov" if prec is None else "prec", r.shape[0])
    if prec is not None:
        g = torch.einsum("sij,sj->si", prec, r)
        cbar = torch.diagonal(prec, dim1=1, dim2=2)
        quad = torch.einsum("si,si->s", r, g)
        return g, cbar, quad, None
    chol, info = torch.linalg.cholesky_ex(cov)
    failed = info != 0
    linv = _tri_inverse(chol)
    lr = torch.bmm(linv, r[:, :, None])  # L^{-1} r
    g = torch.bmm(linv.mT, lr)[:, :, 0]  # L^{-T} L^{-1} r = P r
    cbar = torch.einsum("ski,ski->si", linv, linv)  # diag(P)
    quad = lr[:, :, 0].square().sum(dim=1)  # ||L^{-1} r||^2 = r^T P r
    return g, cbar, quad, failed


def _mvn(g, cbar, failed):
    """The (S, N) MVN conditional log-densities from every draw's terms."""
    eps = torch.finfo(g.dtype).eps
    bad = ~(cbar > 0)  # catches NaN as well as non-positive diagonals
    cbar_safe = torch.where(bad, eps, cbar)
    ll = -0.5 * math.log(2 * math.pi) + 0.5 * torch.log(cbar_safe) - 0.5 * g**2 / cbar_safe
    ll = torch.where(bad, -math.inf, ll)
    # a non-finite entry anywhere in g marks the draw's row
    row_ok = torch.all(torch.isfinite(g) | bad, dim=1, keepdim=True) & ~failed[:, None]
    return torch.where(row_ok, ll, -math.inf)


def _mvt(g, cbar, quad, df, failed):
    """The (S, N) multivariate-t conditional log-densities from every
    draw's terms and its degrees of freedom ``df`` (S,)."""
    N = g.shape[1]
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
        | failed[:, None]
    )
    return torch.where(invalid, -math.inf, ll)


def _by_chunks(y, mu, source, form: str, mesh=None):
    """:func:`_precision_terms` over chunks of draws: ``source`` is the
    chunk source of the (S, N, N) covariances (``form="cov"``) or
    precisions (``form="prec"``), an array or tensor, or a function of the
    chunk's int64 draw indices on its device that returns the chunk's
    matrices there.  Over ``mesh`` chunk ``i`` runs on its device
    ``i % mesh.size``.  Returns every draw's ``(g, cbar, quad, failed)``
    on the computation device."""
    device = compute_device()
    devices = mesh.devices if mesh is not None else (device,)
    ys = {str(d): _as_device(y, d) for d in devices}
    S, N = mu.shape[0], ys[str(devices[0])].shape[0]
    chunk = draws_per_chunk(N)
    g = torch.empty((S, N), dtype=torch.float64, device=device)
    cbar, quad = torch.empty_like(g), g.new_empty(S)
    failed = torch.zeros(S, dtype=torch.bool, device=device)
    for i, start in enumerate(range(0, S, chunk)):
        sl = slice(start, min(start + chunk, S))
        j = i % len(devices)
        on = devices[j]
        with device_scope(on):
            with span("pyloo.draws.generate", c=i, j=j):
                if callable(source):
                    mats = source(torch.arange(sl.start, sl.stop, device=on))
                else:
                    mats = _draws_to(source[sl], on)
            with span("pyloo.draws.factor", c=i, j=j):
                terms = _precision_terms(ys[str(on)], _draws_to(mu[sl], on), **{form: mats})
                g[sl], cbar[sl], quad[sl] = terms[:3]
                if terms[3] is not None:
                    failed[sl] = terms[3]
            del mats, terms
    return g, cbar, quad, failed


def conditional_loglik(y, mu, source, *, form: str = "cov", df=None, mesh=None):
    """``(ll, failed)``: the (S, N) conditional leave-one-out log-densities
    of a joint MVN (``df`` None) or multivariate-t (``df`` (S,)), and the
    (S,) draws whose covariance factorisation failed (none for a
    precision), on ``rcParams["device.device"]``.  ``source`` holds the
    draws' covariances (``form="cov"``) or precisions (``form="prec"``) as
    :func:`_by_chunks` takes them; the chunks make each draw's terms, and
    the densities are computed once from all of them."""
    g, cbar, quad, failed = _by_chunks(y, mu, source, form, mesh)
    if df is None:
        return _mvn(g, cbar, failed), failed
    return _mvt(g, cbar, quad, _draws_to(df, g.device), failed), failed


def mvn_conditional_loglik(y, mu, cov=None, prec=None, *, mesh=None):
    """(S, N) conditional leave-one-out log-densities for a joint MVN.

    log p(y_i | y_-i, theta_s) = -0.5 log 2pi + 0.5 log Pbar_ii
    - 0.5 g_i^2 / Pbar_ii.  A covariance draw that is not positive definite
    gives a ``-inf`` row.  ``y`` is (N,), ``mu`` (S, N) and ``cov`` or
    ``prec`` (S, N, N), numpy arrays or tensors; the result is a tensor on
    ``rcParams["device.device"]``.  ``mesh`` deals the chunks of draws
    over its devices.
    """
    form, mats = ("cov", cov) if cov is not None else ("prec", prec)
    return conditional_loglik(y, mu, mats, form=form, mesh=mesh)[0]


def mvt_conditional_loglik(y, mu, df, cov=None, prec=None, *, mesh=None):
    """(S, N) conditional LOO log-densities for a joint multivariate-t.

    The conditional is a Student-t with df+N-1 degrees of freedom, location
    y_i - g_i/Pbar_ii and scale^2 (df + beta_-i)/(df+N-1)/Pbar_ii.  ``df``
    is (S,); draws with ``df <= 0`` give ``-inf`` rows.  Inputs, result and
    ``mesh`` as in :func:`mvn_conditional_loglik`.
    """
    form, mats = ("cov", cov) if cov is not None else ("prec", prec)
    return conditional_loglik(y, mu, mats, form=form, df=df, mesh=mesh)[0]
