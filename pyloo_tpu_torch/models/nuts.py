"""Multinomial No-U-Turn Sampler in PyTorch, chains as the batch axis.

Counterpart of ``pyloo_tpu/models/nuts.py``: the iterative doubling loop of
multinomial NUTS (Hoffman & Gelman 2014; multinomial sampling and the
generalised stopping rule of Betancourt 2017), with a checkpoint per subtree
level for the within-subtree U-turn checks (leaf ``m`` writes slot ``j`` when
``m % 2^j == 0``, so at a leaf with ``t`` trailing one-bits slot ``j <= t``
holds the left edge of the size-``2^j`` subtree ending there), and the warmup
of ``hmc.py``: dual averaging of the step size on the trajectory's mean
Metropolis statistic and a diagonal mass matrix from Welford sums, with the
dual averaging restarted where the mass matrix is adopted.

The chains run in lockstep, as they do under ``jax.vmap`` in ``pyloo_tpu``:
every chain still building a tree takes the same doubling ``d`` and leaf
``m``, which are host integers, so the checkpoint slots a leaf writes and
reads are host arithmetic and plain indexing.  A chain that has stopped (it
turned, diverged or is done) is frozen by ``torch.where``.  The step loop's
one host read is "is any chain still building", once per doubling, through
:func:`pyloo_tpu_torch.models.hmc._host_value`; everything else stays on the
device.  Each leaf costs one vmapped ``grad_and_value``: a position carries
its potential and gradient, as in ``hmc.py`` (``pyloo_tpu`` evaluates the
gradient twice and the potential once per leaf; the values are the same).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from . import hmc

__all__ = ["sample_nuts"]

_DIVERGENCE = 1000.0


def _trailing_ones(n: int) -> int:
    t = 0
    while n & 1:
        n >>= 1
        t += 1
    return t


def _trailing_zeros(n: int) -> int:
    return (n & -n).bit_length() - 1


def _is_turning(inv_mass, dq, p_a, p_b):
    """``dq`` is the trajectory's span ``q+ - q-``; ``p_a`` and ``p_b`` the
    momenta at its two ends (the test is symmetric in them)."""
    return (torch.sum(dq * (inv_mass * p_a), dim=-1) < 0.0) | (
        torch.sum(dq * (inv_mass * p_b), dim=-1) < 0.0
    )


class _GeneratorDraws:
    """The random draws of the sampler from one ``torch.Generator``: a
    standard-normal momentum ``(C, D)`` per step, a direction and a merge
    uniform ``(C,)`` per doubling and an acceptance uniform ``(C,)`` per leaf."""

    def __init__(self, generator: torch.Generator, C: int, D: int, dtype, device):
        self.generator, self.C, self.D = generator, C, D
        self.dtype, self.device = dtype, device

    def momentum(self, t: int):
        return torch.randn((self.C, self.D), generator=self.generator, dtype=self.dtype,
                           device=self.device)

    def doubling(self, t: int, d: int):
        u = torch.rand((2, self.C), generator=self.generator, dtype=self.dtype,
                       device=self.device)
        return u[0], u[1]

    def leaf(self, t: int, d: int, m: int):
        return torch.rand((self.C,), generator=self.generator, dtype=self.dtype,
                          device=self.device)


def _trajectory(value_and_grad, q0, pot0, g0, eps, inv_mass, draws, t: int, max_depth: int):
    """One NUTS transition of every chain from ``q0`` (C, D), whose potential
    (C,) and gradient (C, D) are ``pot0`` / ``g0``; ``eps`` (C,) and
    ``inv_mass`` (C, D) per chain.

    Returns ``(q, potential, gradient)`` of the proposal, the accept
    statistic (C,), the tree depth (C,), whether the chain diverged (C,), and
    the number of doublings the chains took together.
    """
    C, D = q0.shape
    dtype, device = q0.dtype, q0.device
    p0 = draws.momentum(t) / torch.sqrt(inv_mass)
    h0 = pot0 + 0.5 * torch.sum(inv_mass * p0**2, dim=1)

    # endpoints (q, p, gradient) in each direction, the proposal with its
    # potential and gradient, its total log weight, and the flags
    minus = (q0, p0, g0)
    plus = (q0, p0, g0)
    prop = (q0, pot0, g0)
    log_w = -h0
    depth = torch.zeros((C,), dtype=torch.int64, device=device)
    turning = torch.zeros((C,), dtype=torch.bool, device=device)
    diverged = torch.zeros((C,), dtype=torch.bool, device=device)
    alpha_sum = torch.zeros((C,), dtype=dtype, device=device)
    n_alpha = torch.zeros((C,), dtype=dtype, device=device)

    def pick(cond, new, old):
        c = cond[:, None] if new.dim() == 2 else cond
        return torch.where(c, new, old)

    ckpt_q = torch.zeros((C, max_depth + 1, D), dtype=dtype, device=device)
    ckpt_p = torch.zeros_like(ckpt_q)
    d = 0
    while True:
        building = ~(turning | diverged)
        u_dir, u_merge = draws.doubling(t, d)
        forward = u_dir >= 0.5  # direction +1; -1 where the uniform is below 1/2
        direction = torch.where(forward, 1.0, -1.0).to(dtype)
        q, p, g = (pick(forward, a, b) for a, b in zip(plus, minus))
        e = (direction * eps)[:, None]
        half, step = 0.5 * e, e * inv_mass

        # the subtree: 2^d leaves from the chosen edge; a chain that is not
        # building starts it stopped, so every leaf leaves it as it is
        # (the first leaf of a building chain always takes the proposal, so
        # the edge's potential, which is not carried, is never read)
        sub_q_prop, sub_g_prop = q, g
        sub_pot_prop = torch.zeros((C,), dtype=dtype, device=device)
        sub_log_w = torch.full((C,), -math.inf, dtype=dtype, device=device)
        sub_turning, sub_diverged = ~building, torch.zeros_like(building)
        sub_alpha = torch.zeros((C,), dtype=dtype, device=device)
        sub_n = torch.zeros((C,), dtype=dtype, device=device)
        for m in range(1 << d):
            stop = sub_turning | sub_diverged
            p_half = p - half * g
            q_new = q + step * p_half
            pot_new, g_new = value_and_grad(q_new)
            p_new = p_half - half * g_new
            h = pot_new + 0.5 * torch.sum(inv_mass * p_new**2, dim=1)
            h = torch.where(torch.isfinite(h), h, math.inf)
            leaf_diverged = (h - h0) > _DIVERGENCE

            # multinomial proposal within the subtree
            log_w_new = torch.logaddexp(sub_log_w, -h)
            take = draws.leaf(t, d, m) < torch.exp(-h - log_w_new)
            alpha = torch.clamp(torch.exp(torch.clamp(h0 - h, max=0.0)), max=1.0)

            # leaf m is the left edge of every subtree of size 2^j with
            # m % 2^j == 0; the U-turn checks of every balanced subtree
            # ending at leaf m read slots 1..(trailing ones of m)
            n_write = max_depth + 1 if m == 0 else _trailing_zeros(m) + 1
            ckpt_q[:, :n_write] = q_new[:, None]
            ckpt_p[:, :n_write] = p_new[:, None]
            t_ones = _trailing_ones(m)
            leaf_turning = torch.zeros_like(stop)
            if t_ones:
                cq, cp = ckpt_q[:, 1 : t_ones + 1], ckpt_p[:, 1 : t_ones + 1]
                dq = torch.where(forward[:, None, None], q_new[:, None] - cq, cq - q_new[:, None])
                leaf_turning = torch.any(
                    _is_turning(inv_mass[:, None], dq, cp, p_new[:, None]), dim=1
                )

            # a stopped chain keeps its subtree as it was
            go = ~stop
            keep_new = go & take
            sub_q_prop = pick(keep_new, q_new, sub_q_prop)
            sub_pot_prop = pick(keep_new, pot_new, sub_pot_prop)
            sub_g_prop = pick(keep_new, g_new, sub_g_prop)
            q, p, g = pick(go, q_new, q), pick(go, p_new, p), pick(go, g_new, g)
            sub_log_w = pick(go, log_w_new, sub_log_w)
            sub_turning = sub_turning | (go & leaf_turning)
            sub_diverged = sub_diverged | (go & leaf_diverged)
            sub_alpha = pick(go, sub_alpha + alpha, sub_alpha)
            sub_n = pick(go, sub_n + 1.0, sub_n)

        # progressive multinomial merge of the subtree's proposal; only the
        # chains that were building take this doubling
        sub_turning = sub_turning & building
        sub_ok = building & ~(sub_turning | sub_diverged)
        log_w_total = torch.logaddexp(log_w, sub_log_w)
        take = sub_ok & (u_merge < torch.exp(sub_log_w - log_w_total))
        prop = tuple(pick(take, a, b) for a, b in zip((sub_q_prop, sub_pot_prop, sub_g_prop), prop))
        log_w = pick(sub_ok, log_w_total, log_w)
        minus = tuple(pick(sub_ok & ~forward, a, b) for a, b in zip((q, p, g), minus))
        plus = tuple(pick(sub_ok & forward, a, b) for a, b in zip((q, p, g), plus))
        whole_turn = _is_turning(inv_mass, plus[0] - minus[0], minus[1], plus[1])

        depth = depth + building.to(depth.dtype)
        turning = turning | sub_turning | (sub_ok & whole_turn)
        diverged = diverged | (building & sub_diverged)
        alpha_sum = pick(building, alpha_sum + sub_alpha, alpha_sum)
        n_alpha = pick(building, n_alpha + sub_n, n_alpha)
        d += 1
        # the one host read of a doubling: is any chain still building?
        if not hmc._host_value(torch.any(~(turning | diverged))) or d == max_depth:
            break

    accept_stat = alpha_sum / torch.clamp(n_alpha, min=1.0)
    return prop, accept_stat, depth, diverged, d


def _run_chains(
    value_and_grad: Callable,
    init_q: torch.Tensor,
    draws,
    num_warmup: int,
    num_samples: int,
    max_depth: int,
    target_accept: float,
):
    """Run all chains: ``init_q`` (C, D) -> draws (C, num_samples, D), the
    accept statistics (C, num_samples), tree depths (C, num_samples),
    divergences (C, num_samples), as tensors on ``init_q``'s device, and the
    number of doublings the chains took together over the run (one host read
    each).
    """
    C, D = init_q.shape
    dtype, device = init_q.dtype, init_q.device
    total = num_warmup + num_samples
    mm_lo, mm_hi = int(num_warmup * 0.25), int(num_warmup * 0.85)
    gamma, t0, kappa = 0.05, 10.0, 0.75
    eps0 = 0.1

    # dual averaging, per chain; its step count is the same in every chain
    log_eps = torch.full((C,), math.log(eps0), dtype=dtype, device=device)
    log_eps_avg = log_eps.clone()
    h_sum = torch.zeros((C,), dtype=dtype, device=device)
    mu = torch.full((C,), math.log(10.0 * eps0), dtype=dtype, device=device)
    count = 0.0
    w_mean = torch.zeros((C, D), dtype=dtype, device=device)
    w_m2 = torch.zeros((C, D), dtype=dtype, device=device)
    w_n = 0.0
    inv_mass = torch.ones((C, D), dtype=dtype, device=device)

    q = init_q
    potential, grad = value_and_grad(q)
    out_q = torch.empty((C, num_samples, D), dtype=dtype, device=device)
    out_acc = torch.empty((C, num_samples), dtype=dtype, device=device)
    out_depth = torch.empty((C, num_samples), dtype=torch.int64, device=device)
    out_div = torch.empty((C, num_samples), dtype=torch.bool, device=device)
    doublings = 0

    for t in range(total):
        in_adapt = t < num_warmup
        eps = torch.exp(log_eps if in_adapt else log_eps_avg)
        (q, potential, grad), accept_stat, depth, diverged, n_doublings = _trajectory(
            value_and_grad, q, potential, grad, eps, inv_mass, draws, t, max_depth
        )
        doublings += n_doublings

        if in_adapt:
            count += 1.0
            h_sum = h_sum + (target_accept - accept_stat)
            log_eps = mu - math.sqrt(count) * (1.0 / gamma) * h_sum / (count + t0)
            w = count ** (-kappa)
            log_eps_avg = w * log_eps + (1.0 - w) * log_eps_avg

        if mm_lo <= t < mm_hi:
            w_n += 1.0
            delta = q - w_mean
            w_mean = w_mean + delta / w_n
            w_m2 = w_m2 + delta * (q - w_mean)
        if t == mm_hi:
            # adopt the estimated mass; the optimal step size changes with
            # it, so dual averaging restarts from the current log_eps
            if w_n > 2.0:
                inv_mass = w_m2 / max(w_n - 1.0, 1.0)
            else:
                inv_mass = torch.ones_like(inv_mass)
            log_eps_avg = log_eps
            h_sum = torch.zeros_like(h_sum)
            mu = math.log(10.0) + log_eps
            count = 0.0

        if t >= num_warmup:
            out_q[:, t - num_warmup] = q
            out_acc[:, t - num_warmup] = accept_stat
            out_depth[:, t - num_warmup] = depth
            out_div[:, t - num_warmup] = diverged
    return out_q, out_acc, out_depth, out_div, doublings


def sample_nuts(
    logp_fn: Callable,
    init: np.ndarray,
    *,
    num_warmup: int = 1000,
    num_samples: int = 1000,
    num_chains: int = 4,
    max_depth: int = 8,
    target_accept: float = 0.8,
    seed: int = 0,
    full_stats: bool = False,
):
    """Sample from ``exp(logp_fn(q))`` with multinomial NUTS.

    Parameters mirror :func:`pyloo_tpu_torch.models.hmc.sample_hmc`;
    ``max_depth`` (1 to 30) bounds the trajectory at ``2^max_depth``
    leapfrog steps.

    Returns ``(draws, accept_rate)`` — or, with ``full_stats=True``,
    ``(draws, accept_rate, stats)`` where ``stats`` carries per-draw
    ``accept_stat`` / ``tree_depth`` / ``diverging`` arrays (C, T).

    Runs on ``rcParams["device.device"]``; with ``"cuda"`` and no CUDA device
    this raises.
    """
    if not 1 <= max_depth <= 30:
        raise ValueError(
            f"max_depth must be in [1, 30] (leaf counter is int32), got {max_depth}"
        )
    generator, init_q = hmc._start(init, num_chains, seed)

    def potential(q):
        return -logp_fn(q)

    C, D = init_q.shape
    draws, accs, depths, divs, _ = _run_chains(
        hmc._value_and_grad(potential),
        init_q,
        _GeneratorDraws(generator, C, D, init_q.dtype, init_q.device),
        num_warmup,
        num_samples,
        max_depth,
        target_accept,
    )
    accept = float(accs.mean())
    if full_stats:
        stats = {
            "accept_stat": accs.cpu().numpy(),
            "tree_depth": depths.cpu().numpy().astype(np.int32),
            "diverging": divs.cpu().numpy(),
        }
        return draws.cpu().numpy(), accept, stats
    return draws.cpu().numpy(), accept
