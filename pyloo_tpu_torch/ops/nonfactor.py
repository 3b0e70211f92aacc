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

On a card from N = ``_BLOCKED_FROM`` the factor is blocked
(:func:`blocked_cholesky`): block column ``j`` of width ``_NB`` is the
caller's matrix less one batched product of the columns before it, its
diagonal block factored and inverted by kernel G (:func:`chol_block`,
``csrc/chol_block.cu``) and the rest of it one batched product with that
inverse.  The ``N³ / 3`` flops go to the tensor cores, where cuSOLVER's
``potrfBatched`` (``cholesky_ex``'s route for a batch) takes ~390 launches
a chunk of eight 2,048 x 2,048 matrices at ~4 TFLOP/s; smaller matrices,
whose chunks hold hundreds of draws, keep ``cholesky_ex``, as does the CPU.

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
``factor_draws`` (by form), ``blocked_factor_draws`` (the draws the blocked
factor took) and ``h2d_bytes`` (kind ``draws``: the bytes of a chunk's
inputs that start in host memory) record while a profiler does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from .._common import compute_device
from ..parallel.sharding import device_scope
from ..profiling import count, span
from .topk import _cuda_device, _raise_on

__all__ = ["mvn_conditional_loglik", "mvt_conditional_loglik", "conditional_loglik",
           "draws_per_chunk", "blocked_cholesky", "chol_block", "chol_block_plain"]

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


# the blocked factor's block width (kernel G's widest block), and the
# order from which a card takes it (measured on an H100 at
# draws_per_chunk(N) draws a chunk: PERF.md)
_NB = 128
_BLOCKED_FROM = 256
_CUBLAS_ERROR = 10000  # the library's codes of cuBLAS's failures start there


def _blocked_route(device_type: str, n: int) -> bool:
    """True where :func:`_precision_terms` factors by :func:`blocked_cholesky`:
    on a card from order ``_BLOCKED_FROM``; ``cholesky_ex`` elsewhere."""
    return device_type == "cuda" and n >= _BLOCKED_FROM


def chol_block_plain(c):
    """Plain version of kernel G: ``(L, W, info)`` of a batch of lower
    triangles ``c`` (B, w, w): the factor ``L`` with zeros above its
    diagonal, ``W = L^{-1}``, and ``info`` (B,) int32, 0 or the first column
    (1-based) whose pivot is <= 0 or not finite.  A failed block's ``L``
    and ``W`` hold what ``cholesky_ex`` and the solve leave."""
    chol, info = torch.linalg.cholesky_ex(c)
    w = _solve_inverse(chol)
    nonfinite = ~torch.isfinite(torch.diagonal(chol, dim1=-2, dim2=-1))
    first = torch.where(nonfinite.any(dim=1), nonfinite.int().argmax(dim=1) + 1, 0)
    info = torch.where((info > 0) & ((first == 0) | (info < first)), info, first)
    return chol, w, info.to(torch.int32)


def _stream_of(t):
    """The device index and current stream of a CUDA tensor, for a launch."""
    device = _cuda_device(t.device)
    return device.index, torch.cuda.current_stream(device).cuda_stream


def _count_g(device: int, launches: int = 1) -> None:
    """Kernel G's launches on ``device`` (an index) in its counters."""
    chol_block.launches += launches
    key = f"cuda:{device}"
    chol_block.by_device[key] = chol_block.by_device.get(key, 0) + launches


def chol_block(c, l_out, w_out, info, k0: int = 0) -> None:
    """Kernel G: the diagonal block of :func:`blocked_cholesky`.

    Factors the lower triangles of ``c`` (B, w, w) float64, ``w <= _NB``,
    into ``l_out`` (``L``, zeros above its diagonal) and ``w_out``
    (``L^{-1}``), both (B, w, w) views, and sets ``info`` (B,) int32 to
    ``k0`` + the block's first failed column where it is 0 (LAPACK's
    ``info`` of the whole matrix when the blocks go in order).  A CUDA
    tensor launches ``csrc/chol_block.cu`` on its device and current
    stream, counted in ``launches`` and ``by_device``; a CPU tensor takes
    :func:`chol_block_plain`.  Every matrix needs contiguous rows (column
    stride 1)."""
    b, w = c.shape[0], c.shape[-1]
    for name, t in (("c", c), ("l_out", l_out), ("w_out", w_out)):
        if t.shape != (b, w, w) or t.dtype != torch.float64 or t.device != c.device:
            raise ValueError(f"{name} must be ({b}, {w}, {w}) float64 on {c.device}, got"
                             f" {tuple(t.shape)} {t.dtype} on {t.device}")
        if w > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s rows must be contiguous (column stride 1)")
    if info.shape != (b,) or info.dtype != torch.int32 or info.device != c.device:
        raise ValueError(f"info must be ({b},) int32 on {c.device}")
    if w > _NB:
        raise ValueError(f"kernel G takes blocks of at most {_NB} columns, got {w}")
    if b == 0:
        return
    if c.device.type == "cpu":
        chol, inv, got = chol_block_plain(c)
        l_out.copy_(chol)
        w_out.copy_(inv)
        info.copy_(torch.where((info == 0) & (got > 0), got + k0, info))
        return
    lib, (device, stream) = _build.load(), _stream_of(c)
    code = lib.pyloo_chol_block_f64(
        device, c.data_ptr(), c.stride(0), max(c.stride(1), w), l_out.data_ptr(),
        l_out.stride(0), max(l_out.stride(1), w), w_out.data_ptr(), w_out.stride(0),
        max(w_out.stride(1), w), info.data_ptr(), b, w, k0, stream)
    _raise_on(code, lib, "chol_block")
    _count_g(device)


chol_block.launches = 0
chol_block.by_device = {}


def _block(t, r0: int, c0: int, rows: int, cols: int, transpose: bool = False):
    """``t[:, r0:r0 + rows, c0:c0 + cols]`` of a batch of matrices, or its
    transpose, as one strided view."""
    sb, sr, sc = t.stride()
    size, stride = ((cols, rows), (sc, sr)) if transpose else ((rows, cols), (sr, sc))
    return t.as_strided((t.shape[0], *size), (sb, *stride), t.storage_offset() + r0 * sr + c0 * sc)


def blocked_cholesky(a):
    """``(L, info)`` of a batch ``a`` (B, n, n) float64 as
    ``torch.linalg.cholesky_ex(a)`` gives them (the lower triangle read,
    ``L`` zero above its diagonal, ``info`` 0 or the first failed column),
    factored left-looking over block columns of width ``_NB``: for the
    block column from ``k0`` to ``k1``

        C = A[:, k0:, k0:k1] - L[:, k0:, :k0] L[:, k0:k1, :k0]^T   (one batched product)
        L_jj, W_jj = chol_block(C[:, :w])                           (kernel G, W_jj = L_jj^{-1})
        L[:, k1:, k0:k1] = C[:, w:] W_jj^T                          (one batched product)

    ``a`` is read as it is and ``L`` written once, freshly zeroed.  A
    failed draw's later blocks may hold NaN; the products are batched, so
    they reach no other draw.  On a card one call to the library queues a
    block column's copy, products and kernel G in turn (Python's three
    calls and their views a block column took as long as the card's work
    a chunk); on the CPU this loop does, with :func:`chol_block`'s plain
    version."""
    if a.shape[-1] > 1 and a.stride(-1) != 1:
        a = a.contiguous()
    b, n = a.shape[0], a.shape[-1]
    chol = a.new_zeros(a.shape)
    info = torch.zeros(b, dtype=torch.int32, device=a.device)
    if b == 0:
        return chol, info
    width = min(_NB, n)
    w_jj = a.new_empty((b, width, width))
    col_buf = a.new_empty((b, n, width)) if n > _NB else None
    if a.device.type != "cpu":
        lib, (device, stream) = _build.load(), _stream_of(a)
        code = lib.pyloo_blocked_cholesky_f64(
            device, a.data_ptr(), a.stride(0), max(a.stride(1), n), chol.data_ptr(),
            0 if col_buf is None else col_buf.data_ptr(), w_jj.data_ptr(), info.data_ptr(), b, n,
            stream)
        if code >= _CUBLAS_ERROR:
            raise RuntimeError(f"blocked_cholesky: cuBLAS status {code - _CUBLAS_ERROR}")
        _raise_on(code, lib, "blocked_cholesky")
        _count_g(device, -(-n // _NB))
        return chol, info
    for k0 in range(0, n, _NB):
        k1 = min(k0 + _NB, n)
        w, m = k1 - k0, n - k0
        col = _block(a, k0, k0, m, w)
        if k0:
            col = torch.baddbmm(col, _block(chol, k0, 0, m, k0), _block(chol, k0, 0, w, k0, True),
                                alpha=-1, out=_block(col_buf, 0, 0, m, w))
        inv = _block(w_jj, 0, 0, w, w)
        chol_block(_block(col, 0, 0, w, w), _block(chol, k0, k0, w, w), inv, info, k0)
        if k1 < n:
            torch.bmm(_block(col, w, 0, m - w, w), _block(inv, 0, 0, w, w, True),
                      out=_block(chol, k1, k0, m - w, w))
    return chol, info


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
    if _blocked_route(cov.device.type, cov.shape[-1]):
        chol, info = blocked_cholesky(cov)
        count("blocked_factor_draws", "cov", r.shape[0])
    else:
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
