"""All K fold refits as one batched HMC run on the device.

Counterpart of ``pyloo_tpu/models/batched_refit.py``.  The reference refits
serially: K full MCMC runs one after the other (reference
``pyloo/loo_kfold.py:607-672``).  Equal-sized folds give identically shaped
training subsets, so the K folds x C chains form one ``(K*C, D)`` state of
:func:`pyloo_tpu_torch.models.hmc._run_chains`; each fold's training rows
are gathered into a ``(K, n_train, ...)`` data batch that the vmapped
``logp`` reads, and every fold's held-out log-likelihood is evaluated in
one more vmapped call.

Eligibility is decided by the caller (:func:`pyloo_tpu_torch.loo_kfold.loo_kfold`,
:func:`pyloo_tpu_torch.reloo.reloo`): equal fold sizes, the default HMC
algorithm, no custom sampler, no per-observation parameter shapes
(``model.builder is None``), and ``save_fits=False``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._common import compute_device
from .hmc import _run_chains, _step_draws
from .wrapper import as_tensors

__all__ = ["kfold_refit_batched"]


def kfold_refit_batched(
    model,
    train_idx: np.ndarray,
    val_idx: np.ndarray,
    *,
    draws: int = 1000,
    tune: int = 1000,
    chains: int = 4,
    seed: int = 0,
    num_leapfrog: int = 32,
    target_accept: float = 0.8,
):
    """Refit all folds at once; return held-out elpd contributions.

    Parameters
    ----------
    model : Model
        The functional model (full data; per-fold subsets are gathered from
        ``model.obs_keys`` with the index matrices).
    train_idx : (K, n_train) int array
    val_idx : (K, n_val) int array

    Returns
    -------
    elpd : (K, n_val) ndarray
        ``log mean_s p(y_i | theta_s)`` over each fold's posterior draws.
    accept : (K,) ndarray
        Mean post-warmup acceptance per fold (sanity diagnostic).

    Runs on ``rcParams["device.device"]``; with ``"cuda"`` and no CUDA device
    this raises.  A failure inside the run raises: there is no fallback.
    """
    device = compute_device()
    dtype = torch.float64
    train_idx, val_idx = np.asarray(train_idx), np.asarray(val_idx)
    K = train_idx.shape[0]
    static = as_tensors(
        {k: v for k, v in model.data.items() if k not in model.obs_keys}, device, dtype
    )
    obs_train = as_tensors(
        {k: np.asarray(model.data[k])[train_idx] for k in model.obs_keys}, device, dtype
    )
    obs_val = as_tensors(
        {k: np.asarray(model.data[k])[val_idx] for k in model.obs_keys}, device, dtype
    )
    D = model.flat_dim
    S = chains * draws

    def potential(q, rows):
        return -model.logp(model.unravel(q), {**static, **rows})

    # folds outside, chains inside: each fold's chains read its own rows
    fold_grads = torch.func.vmap(
        torch.func.vmap(torch.func.grad_and_value(potential), in_dims=(0, None)),
        in_dims=(0, 0),
    )

    def value_and_grad(q):  # (K*C, D)
        grad, value = fold_grads(q.reshape(K, chains, D), obs_train)
        return value.reshape(K * chains), grad.reshape(K * chains, D)

    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    init_q = torch.randn((K * chains, D), generator=generator, dtype=dtype, device=device) * 0.5
    dr, accs = _run_chains(
        value_and_grad,
        init_q,
        _step_draws(generator, K * chains, D, dtype, device),
        tune,
        draws,
        num_leapfrog,
        target_accept,
    )  # (K*C, T, D)

    def log_lik(q, rows):
        return model.log_lik(model.unravel(q), {**static, **rows})

    ll = torch.func.vmap(torch.func.vmap(log_lik, in_dims=(0, None)), in_dims=(0, 0))(
        dr.reshape(K, S, D), obs_val
    )  # (K, S, n_val)
    m = ll.amax(dim=1)
    ms = torch.where(torch.isfinite(m), m, 0.0)
    elpd = ms + torch.log(torch.sum(torch.exp(ll - ms[:, None, :]), dim=1)) - math.log(S)
    accept = accs.reshape(K, S).mean(dim=1)
    return elpd.cpu().numpy(), accept.cpu().numpy()
