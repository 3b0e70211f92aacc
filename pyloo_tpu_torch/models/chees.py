"""ChEES-HMC in PyTorch: an adapted trajectory length shared by all chains.

Counterpart of ``pyloo_tpu/models/chees.py`` (Hoffman, Radul & Sountsov
2021): Adam on the log trajectory time ascends the ChEES criterion
``1/4 E[(||q' - E q'||^2 - ||q - E q||^2)^2]``, a cross-chain expectation,
with a Halton-jittered length each iteration.  Every chain takes the same
number of leapfrog steps, each with its own jittered step size, so the
chains are one ``(C, D)`` state.

The step count depends on the adapted step size and trajectory time, which
live on the device, so it is read on the host once an iteration (through
:func:`pyloo_tpu_torch.models.hmc._host_value`); that is the loop's only
host read.  The Halton value depends only on the iteration and is computed
on the host.  A position carries its potential and gradient, so a
trajectory of ``L`` steps costs ``L`` vmapped ``grad_and_value`` calls
(``pyloo_tpu`` evaluates ``2L`` gradients and two potentials).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from . import hmc

__all__ = ["sample_chees"]


def _halton(i: int) -> float:
    """Radical inverse in base 2 of ``i``, to 16 binary digits."""
    result, f = 0.0, 0.5
    for _ in range(16):
        result += f * (i % 2)
        i //= 2
        f *= 0.5
    return result


def _run_chains(
    value_and_grad: Callable,
    init_q: torch.Tensor,
    draws: Callable,
    num_warmup: int,
    num_samples: int,
    max_leapfrog: int,
    target_accept: float,
    step_size_jitter: float,
):
    """Run all chains: ``init_q`` (C, D) -> draws (C, num_samples, D) and the
    accept probabilities (C, num_samples) as tensors on ``init_q``'s device,
    and the leapfrog count of every iteration (a list of ints; one host read
    each).  ``draws(t)`` gives iteration ``t``'s momenta, step-size jitter
    and accept uniforms, as ``hmc._step_draws`` makes them."""
    C, D = init_q.shape
    dtype, device = init_q.dtype, init_q.device
    total = num_warmup + num_samples
    mm_lo, mm_hi = int(num_warmup * 0.25), int(num_warmup * 0.85)
    gamma, t0, kappa = 0.05, 10.0, 0.75
    b1, b2, lr = 0.9, 0.95, 0.025
    eps0 = 0.1

    def scalar(x):  # a fill, not a copy from the host
        return torch.full((), x, dtype=dtype, device=device)

    # dual averaging on the mean accept across chains (one step size)
    log_eps, log_eps_avg, h_sum = scalar(math.log(eps0)), scalar(math.log(eps0)), scalar(0.0)
    mu_da = math.log(10 * eps0)
    da_count = 0.0
    # Adam on the log trajectory time, from a time of 1.0
    log_t, adam_m, adam_v = scalar(0.0), scalar(0.0), scalar(0.0)
    adam_count = 0.0
    # pooled Welford sums: the chains are extra samples
    w_mean = torch.zeros((D,), dtype=dtype, device=device)
    w_m2 = torch.zeros((D,), dtype=dtype, device=device)
    w_n = 0.0
    inv_mass = torch.ones((D,), dtype=dtype, device=device)

    q = init_q
    potential, grad = value_and_grad(q)
    out_q = torch.empty((C, num_samples, D), dtype=dtype, device=device)
    out_acc = torch.empty((C, num_samples), dtype=dtype, device=device)
    steps = []

    for t in range(total):
        z, u_eps, u_acc = draws(t)
        in_adapt = t < num_warmup
        eps = torch.exp(log_eps if in_adapt else log_eps_avg)

        # Halton-jittered trajectory time; the step count is shared (lockstep)
        h = _halton(t + 1)
        n_steps = torch.clamp(torch.ceil(h * torch.exp(log_t) / eps), 1, max_leapfrog)
        n_steps = int(hmc._host_value(n_steps))
        steps.append(n_steps)
        # per-chain step size, uniform in eps * [1 - j, 1 + j]
        eps_c = (eps * (1.0 + step_size_jitter * (2.0 * u_eps - 1.0)))[:, None]

        p = z / torch.sqrt(inv_mass)[None, :]
        h0 = potential + 0.5 * torch.sum(inv_mass[None, :] * p**2, dim=1)
        q_new, p_new, potential_new, grad_new = hmc._leapfrog(
            value_and_grad, q, p, potential, grad, eps_c, inv_mass[None, :], n_steps
        )
        h1 = potential_new + 0.5 * torch.sum(inv_mass[None, :] * p_new**2, dim=1)
        log_accept = torch.where(torch.isfinite(h1), h0 - h1, -math.inf)
        accept_prob = torch.clamp(torch.exp(torch.clamp(log_accept, max=0.0)), max=1.0)
        accept = u_acc < accept_prob
        q_next = torch.where(accept[:, None], q_new, q)

        if in_adapt:
            # ChEES gradient for log T (paper eq. 6, accept-prob weighted),
            # ascended by Adam on its negative
            centred_new = q_new - torch.mean(q_new, dim=0)[None, :]
            dsq = torch.sum(centred_new**2, dim=1) - torch.sum(
                (q - torch.mean(q, dim=0)[None, :]) ** 2, dim=1
            )
            per_chain = dsq * torch.sum(centred_new * p_new, dim=1) * h
            g = -(torch.sum(accept_prob * per_chain)
                  / torch.clamp(torch.sum(accept_prob), min=1e-6))
            adam_m = b1 * adam_m + (1 - b1) * g
            adam_v = b2 * adam_v + (1 - b2) * g**2
            adam_count += 1.0
            m_hat = adam_m / (1 - b1**adam_count)
            v_hat = adam_v / (1 - b2**adam_count)
            log_t = log_t - lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
            # keep trajectories realizable: between one and max_leapfrog steps
            log_t = torch.minimum(torch.maximum(log_t, torch.log(torch.exp(log_eps))),
                                  torch.log(max_leapfrog * torch.exp(log_eps)))

            da_count += 1.0
            h_sum = h_sum + (target_accept - torch.mean(accept_prob))
            log_eps = mu_da - math.sqrt(da_count) * (1.0 / gamma) * h_sum / (da_count + t0)
            w = da_count ** (-kappa)
            log_eps_avg = w * log_eps + (1.0 - w) * log_eps_avg

        q = q_next
        potential = torch.where(accept, potential_new, potential)
        grad = torch.where(accept[:, None], grad_new, grad)

        if mm_lo <= t < mm_hi:
            n1 = w_n + C
            delta = q - w_mean[None, :]
            w_mean = w_mean + torch.sum(delta, dim=0) / n1
            w_m2 = w_m2 + torch.sum(delta * (q - w_mean[None, :]), dim=0)
            w_n = n1
        if t == mm_hi:  # adopt the pooled estimate at the end of the window
            if w_n > 2.0:
                inv_mass = w_m2 / max(w_n - 1.0, 1.0)
            else:
                inv_mass = torch.ones_like(inv_mass)

        if t >= num_warmup:
            out_q[:, t - num_warmup] = q
            out_acc[:, t - num_warmup] = accept_prob
    return out_q, out_acc, steps


def sample_chees(
    logp_fn: Callable,
    init: np.ndarray,
    *,
    num_warmup: int = 1000,
    num_samples: int = 1000,
    num_chains: int = 16,
    max_leapfrog: int = 512,
    target_accept: float = 0.75,
    step_size_jitter: float = 0.2,
    seed: int = 0,
):
    """Sample with ChEES-adapted HMC (shared adaptive trajectory length).

    Same contract as :func:`pyloo_tpu_torch.models.hmc.sample_hmc`; returns
    ``(draws (C, T, D), mean_accept)``.

    The ChEES criterion is a cross-chain expectation, so its gradient is
    noisy at few chains: the default is 16 chains.  ``step_size_jitter``
    (fraction, default 0.2) draws each chain's step size uniformly in
    ``eps * [1-j, 1+j]`` per iteration while the leapfrog step count stays
    shared across chains.

    Runs on ``rcParams["device.device"]``; with ``"cuda"`` and no CUDA device
    this raises.
    """
    if not 0.0 <= step_size_jitter < 1.0:
        raise ValueError(
            f"step_size_jitter must be in [0, 1), got {step_size_jitter}"
        )
    generator, init_q = hmc._start(init, num_chains, seed)

    def potential(q):
        return -logp_fn(q)

    C, D = init_q.shape
    draws, accs, _ = _run_chains(
        hmc._value_and_grad(potential),
        init_q,
        hmc._step_draws(generator, C, D, init_q.dtype, init_q.device),
        num_warmup,
        num_samples,
        max_leapfrog,
        target_accept,
        step_size_jitter,
    )
    return draws.cpu().numpy(), float(accs.mean())
