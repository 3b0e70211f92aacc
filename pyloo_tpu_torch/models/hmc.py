"""Adaptive Hamiltonian Monte Carlo in PyTorch, chains as the batch axis.

Counterpart of ``pyloo_tpu/models/hmc.py``.  The chains are one ``(C, D)``
state and the gradient comes from ``torch.func.vmap(torch.func.grad(...))``
of the potential; the step loop is a Python loop over ``num_warmup +
num_samples`` steps.  Warmup follows the Stan scheme, as in ``pyloo_tpu``:
dual-averaging step size (Nesterov 2009; Hoffman & Gelman 2014 §3.2)
targeting 0.8 acceptance and a diagonal mass matrix estimated by Welford's
algorithm over the window ``[0.25, 0.85) x warmup``.

Everything a step carries (positions, potentials and gradients, the dual
averaging state, the Welford sums, the inverse mass) stays on the device as
tensors, and accept / reject is a ``torch.where``.  The loop reads no device
value on the host: what it branches on is the step counter, which is the
host's own (whether the step is in warmup, in the mass window, or at its
end).  The whole fit is one stream of launches.

The gradient at each position is evaluated once: the half kick that closes a
leapfrog step and the one that opens the next read the same gradient, and
the potential of the end point comes with it (``torch.func.grad_and_value``),
so a trajectory of ``L`` steps costs ``L`` gradient evaluations.  The JAX
program evaluates ``2L + 2``; the values are the same.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .._common import compute_device

__all__ = ["sample_hmc"]


def _value_and_grad(potential: Callable) -> Callable:
    """``(C, D) -> (potential (C,), gradient (C, D))`` over the chains."""
    batched = torch.func.vmap(torch.func.grad_and_value(potential))

    def value_and_grad(q):
        grad, value = batched(q)
        return value, grad

    return value_and_grad


def _host_value(x: torch.Tensor):
    """``x.item()``: the one host read of a step of the NUTS and ChEES loops
    (NUTS: whether any chain is still building its tree, once a doubling;
    ChEES: the leapfrog count shared by the chains, once an iteration).
    Every such read goes through here, so it can be counted."""
    return x.item()


def _leapfrog(value_and_grad, q, p, potential_q, grad_q, eps, inv_mass, n_steps):
    """``n_steps`` of leapfrog integration with a diagonal mass matrix.

    ``potential_q`` and ``grad_q`` belong to the start ``q``; returns the end
    point ``(q, p)`` with its potential and gradient.
    """
    potential, grad = potential_q, grad_q
    for _ in range(n_steps):
        p = p - 0.5 * eps * grad
        q = q + eps * inv_mass * p
        potential, grad = value_and_grad(q)
        p = p - 0.5 * eps * grad
    return q, p, potential, grad


def _step_draws(generator: torch.Generator, C: int, D: int, dtype, device) -> Callable:
    """The three random draws of a step, from one generator: standard-normal
    momenta ``(C, D)``, the step-size jitter uniform ``(C,)`` and the accept
    uniform ``(C,)``."""

    def draws(t: int):
        z = torch.randn((C, D), generator=generator, dtype=dtype, device=device)
        u = torch.rand((2, C), generator=generator, dtype=dtype, device=device)
        return z, u[0], u[1]

    return draws


def _start(init, num_chains: int, seed: int):
    """``(generator, init_q)``: the ``torch.Generator`` on the computation
    device, seeded, that makes every random draw of a run, and the chains'
    starts ``(C, D)`` there: ``init`` itself when it is ``(C, D)``, else the
    vector ``init`` plus 0.5 x standard normals per chain (the generator's
    first draws)."""
    device = compute_device()
    init = torch.tensor(np.asarray(init), dtype=torch.float64, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    if init.ndim == 1:
        jitter = torch.randn(
            (num_chains, init.numel()), generator=generator, dtype=init.dtype, device=device
        ) * 0.5
        return generator, init[None, :] + jitter
    return generator, init


def _run_chains(
    value_and_grad: Callable,
    init_q: torch.Tensor,
    draws: Callable,
    num_warmup: int,
    num_samples: int,
    num_leapfrog: int,
    target_accept: float,
):
    """Run all chains: ``init_q`` (C, D) -> draws (C, num_samples, D) and the
    accept probabilities (C, num_samples), as tensors on ``init_q``'s device.

    ``value_and_grad`` maps positions (C, D) to the potential (C,) and its
    gradient (C, D); ``draws(t)`` gives step ``t``'s momenta, jitter and
    accept uniforms.
    """
    C, D = init_q.shape
    dtype, device = init_q.dtype, init_q.device
    total = num_warmup + num_samples
    # mass-matrix estimation window: central slice of warmup
    mm_lo, mm_hi = int(num_warmup * 0.25), int(num_warmup * 0.85)
    gamma, t0, kappa = 0.05, 10.0, 0.75
    eps0 = 0.1  # crude init: eps giving a non-degenerate single step

    # dual averaging, per chain; its step count is the same in every chain
    log_eps = torch.full((C,), math.log(eps0), dtype=dtype, device=device)
    log_eps_avg = log_eps.clone()
    h_sum = torch.zeros((C,), dtype=dtype, device=device)
    mu = math.log(10.0 * eps0)
    count = 0.0
    # Welford accumulation of the posterior variance for the mass matrix
    w_mean = torch.zeros((C, D), dtype=dtype, device=device)
    w_m2 = torch.zeros((C, D), dtype=dtype, device=device)
    w_n = 0.0
    inv_mass = torch.ones((C, D), dtype=dtype, device=device)

    q = init_q
    potential, grad = value_and_grad(q)
    out_q = torch.empty((C, num_samples, D), dtype=dtype, device=device)
    out_acc = torch.empty((C, num_samples), dtype=dtype, device=device)

    for t in range(total):
        z, u_jit, u_acc = draws(t)
        in_adapt = t < num_warmup
        eps = torch.exp(log_eps if in_adapt else log_eps_avg)
        # jitter the step size to decorrelate trajectory lengths
        eps = (eps * (0.9 + 0.2 * u_jit))[:, None]

        p = z / torch.sqrt(inv_mass)
        h0 = potential + 0.5 * torch.sum(inv_mass * p**2, dim=1)
        q_new, p_new, potential_new, grad_new = _leapfrog(
            value_and_grad, q, p, potential, grad, eps, inv_mass, num_leapfrog
        )
        h1 = potential_new + 0.5 * torch.sum(inv_mass * p_new**2, dim=1)
        log_accept = torch.where(torch.isfinite(h1), h0 - h1, -math.inf)
        accept_prob = torch.clamp(torch.exp(torch.clamp(log_accept, max=0.0)), max=1.0)
        accept = u_acc < accept_prob
        q = torch.where(accept[:, None], q_new, q)
        potential = torch.where(accept, potential_new, potential)
        grad = torch.where(accept[:, None], grad_new, grad)

        if in_adapt:  # dual averaging (only during warmup)
            count += 1.0
            h_sum = h_sum + (target_accept - accept_prob)
            log_eps = mu - math.sqrt(count) * (1.0 / gamma) * h_sum / (count + t0)
            w = count ** (-kappa)
            log_eps_avg = w * log_eps + (1.0 - w) * log_eps_avg

        if mm_lo <= t < mm_hi:
            w_n += 1.0
            delta = q - w_mean
            w_mean = w_mean + delta / w_n
            w_m2 = w_m2 + delta * (q - w_mean)
        if t == mm_hi:  # adopt the estimated mass at the end of the window
            if w_n > 2.0:
                inv_mass = w_m2 / max(w_n - 1.0, 1.0)
            else:
                inv_mass = torch.ones_like(inv_mass)

        if t >= num_warmup:
            out_q[:, t - num_warmup] = q
            out_acc[:, t - num_warmup] = accept_prob
    return out_q, out_acc


def sample_hmc(
    logp_fn: Callable,
    init: np.ndarray,
    *,
    num_warmup: int = 1000,
    num_samples: int = 1000,
    num_chains: int = 4,
    num_leapfrog: int = 32,
    target_accept: float = 0.8,
    seed: int = 0,
):
    """Sample from ``exp(logp_fn(q))`` with adaptive HMC.

    Parameters
    ----------
    logp_fn : callable
        Unnormalized log density of a flat float64 parameter vector ``q``
        (D,), a torch function that ``torch.func`` can transform.
    init : (D,) or (num_chains, D) array
        Initial position(s); a single vector is jittered per chain.
    seed : int
        Seeds the ``torch.Generator`` on the computation device that makes
        every random draw of the run.

    Returns
    -------
    draws : (num_chains, num_samples, D) ndarray
    accept_rate : float
        Mean post-warmup acceptance probability (sanity diagnostic).

    Runs on ``rcParams["device.device"]``; with ``"cuda"`` and no CUDA device
    this raises.
    """
    generator, init_q = _start(init, num_chains, seed)

    def potential(q):
        return -logp_fn(q)

    C, D = init_q.shape
    draws, accs = _run_chains(
        _value_and_grad(potential),
        init_q,
        _step_draws(generator, C, D, init_q.dtype, init_q.device),
        num_warmup,
        num_samples,
        num_leapfrog,
        target_accept,
    )
    return draws.cpu().numpy(), float(accs.mean())
