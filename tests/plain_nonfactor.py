"""A plain non-factorised LOO of a joint normal model, for the tests.

Bürkner, Gabry & Vehtari 2021 ("Efficient leave-one-out cross-validation
for Bayesian non-factorized normal and Student-t models", Comput. Stat. 36,
arXiv:1810.10559), the multivariate normal case: with the precision
``P = K^{-1}`` of a draw, ``g = P (y - mu)`` and ``c = diag(P)``,

    log p(y_i | y_-i) = -0.5 log 2 pi + 0.5 log c_i - 0.5 g_i^2 / c_i.

For each block of draws the covariance ``K`` is factorised,
``L = cholesky(K)``, and inverted from its factor,
``P = cholesky_inverse(L)``: another route than the port's triangular
solve against the identity.  The ``(N, S)`` columns are then scored with
the plain float64 PSIS of ``tests/oracle.py``, one observation at a time.
Plain torch and numpy; nothing of ``pyloo_tpu_torch`` or JAX.  A frozen
copy, ``benchmark/reference_nonfactor.py``, scores with the benchmark's
torch PSIS instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .oracle import psis_row


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


def loo(y, mu, matrix_fn, n_draws: int, reff: float = 1.0) -> dict:
    """``loo_i``, ``k`` and the totals ``elpd_loo``, ``p_loo`` and ``se``."""
    ll = conditional_loglik(y, mu, matrix_fn, n_draws).cpu().numpy().T  # (N, S)
    loo_i, k, lppd_i = np.empty(ll.shape[0]), np.empty(ll.shape[0]), np.empty(ll.shape[0])
    for i, row in enumerate(ll):
        lw, k[i] = psis_row(-row, reff)
        top = np.max(lw + row)
        loo_i[i] = np.log(np.sum(np.exp(lw + row - top))) + top
        lppd_i[i] = np.log(np.mean(np.exp(row - row.max()))) + row.max()
    elpd = float(np.sum(loo_i))
    return {"loo_i": loo_i, "k": k, "elpd_loo": elpd, "p_loo": float(np.sum(lppd_i)) - elpd,
            "se": float(np.sqrt(ll.shape[0] * np.var(loo_i)))}
