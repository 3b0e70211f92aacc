"""The benchmark's plain non-factorised LOO of a joint normal model.

A frozen copy of ``tests/plain_nonfactor.py`` that scores with the
benchmark's torch PSIS (:func:`benchmark.reference_torch.score_rows`) in
place of the tests' numpy one.  Bürkner, Gabry & Vehtari 2021 ("Efficient
leave-one-out cross-validation for Bayesian non-factorized normal and
Student-t models", Comput. Stat. 36, arXiv:1810.10559), the multivariate
normal case: with the precision ``P = K^{-1}`` of a draw,
``g = P (y - mu)`` and ``c = diag(P)``,

    log p(y_i | y_-i) = -0.5 log 2 pi + 0.5 log c_i - 0.5 g_i^2 / c_i.

For each block of draws the covariance ``K`` is factorised,
``L = cholesky(K)``, and inverted from its factor,
``P = cholesky_inverse(L)``: another route than the program's triangular
solve against the identity.  Everything is computed in the dtype given:
float64 is the reference, float32 the control.  Plain torch and numpy;
nothing of the program or JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import reference_torch


def conditional_loglik(y, mu, matrix_fn, n_draws: int, dtype=torch.float64,
                       block: int = 8) -> torch.Tensor:
    """The ``(n_draws, N)`` conditional log-densities in ``dtype``, the
    covariances of the draws ``idx`` made by ``matrix_fn(idx)``, ``block``
    draws at a time; ``mu`` broadcasts to ``(n_draws, N)``."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    y = torch.as_tensor(y, dtype=torch.float64)
    mu = torch.as_tensor(mu, dtype=torch.float64, device=y.device).expand(n_draws, y.shape[0])
    out = []
    for lo in range(0, n_draws, block):
        idx = torch.arange(lo, min(lo + block, n_draws), device=y.device)
        p = torch.cholesky_inverse(torch.linalg.cholesky(matrix_fn(idx).to(dtype)))
        g = (p @ (y.to(dtype) - mu[idx].to(dtype))[:, :, None])[:, :, 0]
        c = torch.diagonal(p, dim1=1, dim2=2)
        out.append(-0.5 * math.log(2 * math.pi) + 0.5 * torch.log(c) - 0.5 * g * g / c)
    return torch.cat(out)


def loo(y, mu, matrix_fn, n_draws: int, tail: int, dtype=torch.float64,
        block: int = 8) -> dict:
    """``loo_i``, ``k`` (host float64 arrays) and the totals ``elpd_loo``,
    ``p_loo`` and ``se``, computed in ``dtype`` with a PSIS tail of
    ``tail`` draws."""
    rows = conditional_loglik(y, mu, matrix_fn, n_draws, dtype, block).T.contiguous()
    loo_i, k, lpd_i = reference_torch.score_rows(rows, tail, dtype)
    totals = reference_torch.Totals()
    totals.add(loo_i, lpd_i)
    return {"loo_i": loo_i.cpu().numpy(), "k": np.asarray(k.cpu().numpy(), np.float64),
            **totals.result()}
