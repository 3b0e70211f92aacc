"""The benchmark's model, configuration ``logit32_s4000``, made from a seed.

A logistic regression with 32 features: ``beta = 0.3 N(0, 1)`` over 4
chains x 1,000 draws (S = 4,000: Stan's defaults, CmdStan
``num_samples=1000``), ``xw = 0.5 N(0, 1)`` and ``y ~ Bernoulli(0.5)``,
drawn independently of ``xw``.  Everything is made on the computation
device by one ``torch.Generator``, in the order ``beta``, ``xw``, ``y``, so
a seed gives the same model wherever that generator's device is the same.

The log-likelihood of observation ``i`` under draw ``s`` is
``y_i eta - log(1 + exp(eta))`` with ``eta = xw_i . beta_s``; the draws are
stacked ``sample = chain * draws + draw``, as ``loo()`` stacks them.
"""

from __future__ import annotations

import numpy as np
import torch

N_FEATURES = 32
CHAINS, DRAWS = 4, 1_000


def logistic_model(n_obs: int, chains: int, draws: int, seed: int, device):
    """``(xw, yw, beta)`` on ``device``: ``xw`` (n_obs, 32), ``yw`` (n_obs,)
    of 0.0 / 1.0, ``beta`` (chains, draws, 32), all float32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    beta = 0.3 * torch.randn(chains, draws, N_FEATURES, device=device, generator=gen)
    xw = 0.5 * torch.randn(n_obs, N_FEATURES, device=device, generator=gen)
    yw = (torch.rand(n_obs, device=device, generator=gen) < 0.5).float()
    return xw, yw, beta


def log_lik_fn(model):
    """``log_lik_fn(idx)`` for ``loo_streaming``: the (rows, S) float32
    log-likelihood of observations ``idx``, made on their device.  Its work
    is recorded as the ``bench_torch.generator`` range under
    ``torch.profiler``."""
    xw, yw, beta = model
    beta_s = beta.reshape(beta.shape[0] * beta.shape[1], -1)
    zero = xw.new_zeros(())

    def fn(idx):
        with torch.profiler.record_function("bench_torch.generator"):
            eta = xw[idx] @ beta_s.T  # full float32: the caller turns TF32 off
            return yw[idx, None] * eta - torch.logaddexp(eta, zero)

    return fn


def host_log_lik_f64(model, n_rows: int) -> np.ndarray:
    """The first ``n_rows`` observations' log-likelihood as a host
    ``(chains, draws, n_rows)`` float64 array, computed in float64 on the
    model's device one chain at a time and copied into one array."""
    xw, yw, beta = model
    x = xw[:n_rows].double()
    y = yw[:n_rows].double()
    zero = x.new_zeros(())
    out = np.empty((beta.shape[0], beta.shape[1], n_rows), np.float64)
    for c in range(beta.shape[0]):
        eta = beta[c].double() @ x.T  # (draws, n_rows)
        torch.from_numpy(out[c]).copy_(y * eta - torch.logaddexp(eta, zero))
        del eta
    return out


def rows_log_lik_f64(model, rows) -> np.ndarray:
    """The (len(rows), S) log-likelihood of observations ``rows``, recomputed
    on the host in float64 numpy from the model's float32 values."""
    xw, yw, beta = model
    x = xw[torch.as_tensor(rows, device=xw.device)].cpu().numpy().astype(np.float64)
    y = yw[torch.as_tensor(rows, device=yw.device)].cpu().numpy().astype(np.float64)
    b = beta.reshape(-1, beta.shape[-1]).cpu().numpy().astype(np.float64)
    eta = x @ b.T
    return y[:, None] * eta - np.logaddexp(0.0, eta)
