"""Per-chunk scoring and the running sums of ``loo_streaming``.

Counterpart of ``_kernel_for``, ``_accum_after_scores``,
``_accumulate_chunk`` and ``_mixture_chunk`` in ``pyloo_tpu/streaming.py``.
The carry is a dict of 0-d tensors on the device; nothing here reads a
device value on the host, so chunks queue on the card back to back (the
float64 PSIS scorer's deep-tail guard reads its flags once a chunk, after
the chunk's shards are queued, in ``_chunks.Shards.decided``).
Running sums are float64 whatever the computation dtype: float32 sums lose
about 7 digits over 1e7 observations.  Over a mesh each device keeps a carry
of its own, and :func:`combine_carries` makes them one on the host at the
end, as ``pyloo_tpu``'s scalar all-reduces do.
"""

from __future__ import annotations

import math
from functools import partial

import torch

from ..base import ISMethod
from ..ops.loo_kernels import (
    loo_scores_psis,
    loo_scores_psis_fast,
    loo_scores_sis,
    loo_scores_tis,
)
from ..ops.lse import logsumexp

__all__ = ["kernel_for", "init_carry", "accumulate_chunk", "mixture_chunk", "combine_carries"]

_ACC = torch.float64


def kernel_for(method: ISMethod, tail_max: int, dtype: torch.dtype):
    """The per-chunk scorer: float32 PSIS is the fast path (kernel A on the
    card), float64 PSIS the reference-exact one."""
    if method == ISMethod.PSIS:
        if dtype == torch.float32:
            return partial(loo_scores_psis_fast, tail_max=tail_max)
        return partial(loo_scores_psis, tail_max=tail_max)
    if method == ISMethod.SIS:
        return loo_scores_sis
    return loo_scores_tis


def init_carry(method: ISMethod, mixture: bool, dtype: torch.dtype, good_k: float,
               device: torch.device) -> dict:
    def full(value, dt=_ACC):
        return torch.full((), value, dtype=dt, device=device)

    if mixture:
        return {"log_norm": full(-math.inf), "sum_lo": full(0.0), "sum_lo2": full(0.0),
                "sum_lppd": full(0.0)}
    carry = {"sum_e": full(0.0), "sum_e2": full(0.0), "sum_lppd": full(0.0)}
    if method == ISMethod.PSIS:
        carry["good_k"] = full(good_k, dtype)
        carry["n_bad"] = full(0, torch.int32)
        carry["k_max"] = full(-math.inf, dtype)
        if dtype == torch.float32:
            carry["n_degen"] = full(0, torch.int32)
    else:
        carry["diag_min"] = full(math.inf, dtype)
    return carry


def _accum_after_scores(carry, valid, outs, adj, method):
    """Fold one chunk's scores into the carry; returns ``(carry, elpd_i, diag)``."""
    carry = dict(carry)
    if len(outs) == 4:  # float32 PSIS fast path: per-row degeneracy flag
        elpd_i, diag, lppd_i, degen = outs
        carry["n_degen"] = carry["n_degen"] + (degen & valid).sum(dtype=torch.int32)
    else:
        elpd_i, diag, lppd_i = outs
    if adj is not None:  # Jacobian adjustment, already in elpd units
        elpd_i = elpd_i + adj

    elpd_m = torch.where(valid, elpd_i, 0.0).to(_ACC)
    carry["sum_e"] = carry["sum_e"] + elpd_m.sum()
    carry["sum_e2"] = carry["sum_e2"] + (elpd_m * elpd_m).sum()
    carry["sum_lppd"] = carry["sum_lppd"] + torch.where(valid, lppd_i, 0.0).to(_ACC).sum()
    if method == ISMethod.PSIS:
        k = torch.where(valid, diag, -math.inf)
        carry["n_bad"] = carry["n_bad"] + (k > carry["good_k"]).sum(dtype=torch.int32)
        carry["k_max"] = torch.maximum(carry["k_max"], k.amax())
    else:
        carry["diag_min"] = torch.minimum(
            carry["diag_min"], torch.where(valid, diag, math.inf).amin()
        )
    return carry, elpd_i, diag


def accumulate_chunk(ll, valid, carry, adj=None, *, method, tail_max):
    """Score a ``(chunk, S)`` log-likelihood block and fold it into the carry."""
    outs = kernel_for(method, tail_max, ll.dtype)(ll)
    return _accum_after_scores(carry, valid, outs, adj, method)


def mixture_chunk(ll, valid, carry, adj=None):
    """Mix-IS-LOO chunk step (Silva & Zanella 2022; reference
    ``pyloo/loo.py:252-284``).  The normalizer ``log_norm = logsumexp_i(-c_i)``
    couples observations, but it is a logsumexp over the obs axis, a running
    scalar, so the estimator streams in one pass: each chunk adds to the
    normalizer and to the sums of ``log_obs_i`` and its square, and the
    close takes ``elpd_i = log_norm - log_obs_i``."""
    s = ll.shape[1]
    c_i = logsumexp(-ll, dim=1)
    log_obs = logsumexp(-ll - c_i[:, None], dim=1)
    if adj is not None:
        # elpd_i = log_norm - log_obs (+ adj): fold the Jacobian adjustment
        # into the per-obs term so the close stays log_norm - buf
        log_obs = log_obs - adj
    lppd_i = logsumexp(ll, dim=1, b_inv=s)

    chunk_ln = logsumexp(torch.where(valid, -c_i, -math.inf).to(_ACC), dim=0)
    lo = torch.where(valid, log_obs, 0.0).to(_ACC)
    carry = dict(
        carry,
        log_norm=torch.logaddexp(carry["log_norm"], chunk_ln),
        sum_lo=carry["sum_lo"] + lo.sum(),
        sum_lo2=carry["sum_lo2"] + (lo * lo).sum(),
        sum_lppd=carry["sum_lppd"] + torch.where(valid, lppd_i, 0.0).to(_ACC).sum(),
    )
    return carry, log_obs, torch.zeros_like(log_obs)


def _logsumexp_host(values):
    m = max(values)
    if m == -math.inf:
        return m
    return m + math.log(sum(math.exp(v - m) for v in values))


# how the shards' carries combine: every other entry is a sum
_COMBINE = {"good_k": lambda v: v[0], "k_max": max, "diag_min": min,
            "log_norm": _logsumexp_host}


def combine_carries(carries: list) -> dict:
    """The carries of the shards as one dict of host numbers, combined in
    device order: sums added, the k maximum and the ESS minimum taken, and
    the mixture normaliser as one log-sum-exp of the shards' own.  One host
    read a device, taken after every device's chunks are queued."""
    host = [dict(zip(c, torch.stack([v.to(_ACC) for v in c.values()]).tolist()))
            for c in carries]
    out = {}
    for key, value in carries[0].items():
        values = [h[key] for h in host]
        if value.dtype in (torch.int32, torch.int64):
            values = [int(v) for v in values]
        out[key] = _COMBINE[key](values) if key in _COMBINE else sum(values[1:], values[0])
    return out
