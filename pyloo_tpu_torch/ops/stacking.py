"""Stacking weights by EM on the device.

Counterpart of ``pyloo_tpu/ops/stacking.py``.  Stacking weights (Yao,
Vehtari, Simpson, Gelman 2018) maximise
``sum_n log(sum_k w_k exp(elpd_nk))`` over the simplex: the maximum
likelihood of mixture proportions with fixed components, so the EM fixed
point

    w_k <- mean_n( w_k p_nk / sum_j w_j p_nj )

is monotone and stays on the simplex, one matrix-vector product a turn.

``pyloo_tpu`` runs the loop as one ``jax.lax.while_loop`` that tests
``delta > tol`` on the device each turn.  Torch has no such loop, and reading
``delta`` on the host every turn costs a synchronisation each time, so the
turns run in blocks of :data:`BLOCK` on the device with a ``done`` flag read
once a block.  The flag freezes ``w`` from the turn where ``delta <= tol``,
so the weights and the turn count are those at which the JAX loop stops.
"""

from __future__ import annotations

import torch

from .._common import compute_device

__all__ = ["stacking_weights_em", "BLOCK"]

# EM turns queued on the device between two host reads of the stop flag
BLOCK = 64


def _em_solve(exp_elpds: torch.Tensor, max_iters: int, tol: float):
    """``(w, turns)``: the EM loop of ``pyloo_tpu.ops.stacking._em_solve``."""
    K = exp_elpds.shape[1]
    w = torch.full((K,), 1.0 / K, dtype=exp_elpds.dtype, device=exp_elpds.device)
    done = torch.zeros((), dtype=torch.bool, device=exp_elpds.device)
    turns = torch.zeros((), dtype=torch.int64, device=exp_elpds.device)
    for start in range(0, max_iters, BLOCK):
        for _ in range(min(BLOCK, max_iters - start)):
            denom = exp_elpds @ w  # (N,)
            resp = exp_elpds * (w[None, :] / denom[:, None])  # responsibilities
            w_new = resp.mean(dim=0)
            w_new = w_new / w_new.sum()
            delta = (w_new - w).abs().amax()
            w = torch.where(done, w, w_new)
            turns = turns + (~done).to(torch.int64)
            # the JAX loop goes on while delta > tol: a NaN delta stops it too
            done = done | ~(delta > tol)
        if bool(done):
            break
    return w, int(turns)


def stacking_weights_em(pointwise_elpds, max_iters: int = 5000, tol: float = 1e-14):
    """Stacking weights of ``(n_obs, n_models)`` pointwise elpds (log scale).

    The solve runs in float64 on ``rcParams["device.device"]``.  Returns the
    ``(n_models,)`` simplex weights as a float64 tensor there.
    """
    x = torch.as_tensor(pointwise_elpds, dtype=torch.float64, device=compute_device())
    x = x - x.amax(dim=1, keepdim=True)
    w, _ = _em_solve(torch.exp(x), max_iters, tol)
    return w
