"""Exact per-row top-k and the fused PSIS-LOO prepass: kernel wrappers.

Counterpart of ``pyloo_tpu/ops/pallas_topk.py``.  Two hand-written CUDA
kernels for Hopper (``csrc/topk_prepass.cu``, one templated kernel with the
reductions switched on or off) replace the TPU's Pallas kernels:

* kernel A, :func:`loo_prepass` — ``_kernel_fused`` (``pallas_loo_prepass``);
* kernel B, :func:`topk_desc` — ``_kernel_roll``
  (``pallas_topk_desc(variant="roll")``).

Each wrapper launches its kernel for a CUDA tensor, counts the launch in its
``launches`` attribute, and raises when the kernel does not take the input.
For a tensor on the CPU it returns its plain PyTorch version
(:func:`loo_prepass_plain`, :func:`topk_desc_plain`): the same contract from
``torch.topk`` and masked sums, which the CPU tests compare with the JAX
package.  A CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .lse import logsumexp

__all__ = [
    "MAX_S",
    "MAX_K",
    "supports",
    "multipass_parts",
    "loo_prepass",
    "loo_prepass_plain",
    "loo_prepass_multi",
    "topk_desc",
    "topk_desc_plain",
]

# One block holds one row in shared memory: (S + 1024) float32 must fit the
# 227 KB a block may use on an H100.  32768 draws (132 KB) keeps that margin
# and covers every PSIS tail of S <= 32768 (k = 3 sqrt(S) + 1 <= 545).
# Must equal kMaxS / kMaxK in csrc/topk_prepass.cu (which refuses larger).
MAX_S = 32768
MAX_K = 1024
# log(float64 tiny): the reference's tail-cutoff floor (pyloo psis.py:90)
_CUTOFF_FLOOR = float(math.log(2.2250738585072014e-308))


def supports(s: int, k: int) -> bool:
    """Shapes one kernel pass handles: 1 <= k <= min(S, 1024), S <= 32768.

    The TPU kernel's caps (k <= 1024, S <= 64 * list height) came from its
    128-lane tiles; on the card the cap is what one block's shared memory
    holds.  Beyond ``MAX_S``, :func:`multipass_parts` splits the draw axis.
    """
    return 1 <= k <= min(s, MAX_K) and s <= MAX_S


def multipass_parts(s: int, k: int, max_parts: int = 16) -> int | None:
    """Draw-axis part count for :func:`loo_prepass_multi` (1 = single pass).

    ``None`` when no split helps: k > 1024 (each part must return the full
    global k for the merge to stay exact), or more than ``max_parts`` parts.
    Every part is at least ``MAX_S / 2 - max_parts`` wide, so it holds k.
    """
    if not 1 <= k <= MAX_K or s < k:
        return None
    if s <= MAX_S:
        return 1
    parts = -(-s // MAX_S)
    return parts if parts <= max_parts else None


def _check(x: torch.Tensor, k: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"expected a (B, S) tensor, got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if not supports(x.shape[1], k):
        raise ValueError(
            f"the kernel does not support S={x.shape[1]}, k={k}"
            f" (needs 1 <= k <= min(S, {MAX_K}) and S <= {MAX_S})"
        )


def _launch_args(x: torch.Tensor):
    """Device index, row stride and stream for a CUDA launch; raises otherwise."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for a tensor on {x.device}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError("rows must be contiguous (stride 1 along the draws)")
    ld = x.stride(0) if x.shape[0] > 1 else x.shape[1]
    if ld < x.shape[1]:
        raise ValueError(f"row stride {ld} is shorter than the row ({x.shape[1]})")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return x.device.index, ld, stream


def _raise_on(code: int, lib, what: str) -> None:
    if code != 0:
        msg = lib.pyloo_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {code})")


# --------------------------------------------------------------------------
# Kernel A: fused prepass
# --------------------------------------------------------------------------


def loo_prepass_plain(x: torch.Tensor, k: int):
    """Plain version of kernel A: ``(vals, C, log_ntl, log_sum_ll)``.

    For each row of raw ``x = -log_lik``: ``C`` the row max, ``vals`` the
    exact top-k of ``x - C`` descending, ``log_ntl`` the log of the non-tail
    mass ``sum_{x - C <= xcut} exp(x - C)`` with ``xcut = max(vals[k-1],
    log(float64 tiny))``, and ``log_sum_ll = logsumexp(-x)`` over the
    entries that are not ``-inf``.
    """
    c = x.amax(dim=1)
    xs = x - c[:, None]
    vals = torch.topk(xs, k, dim=1, sorted=True).values
    xcut = torch.clamp_min(vals[:, k - 1], _CUTOFF_FLOOR)
    nontail = xs <= xcut[:, None]
    s_nt = torch.where(nontail, torch.exp(xs - xcut[:, None]), 0.0).sum(dim=1)
    log_ntl = xcut + torch.log(s_nt)
    pad = torch.isneginf(x)
    r_min = torch.where(pad, math.inf, x).amin(dim=1)
    s_ll = torch.where(pad, 0.0, torch.exp(r_min[:, None] - x)).sum(dim=1)
    return vals, c, log_ntl, -r_min + torch.log(s_ll)


def loo_prepass(x: torch.Tensor, k: int):
    """Kernel A: fused top-k selection and row reductions for the float32 path.

    ``x`` is a ``(B, S)`` float32 tensor of raw ``-log_lik`` whose rows are
    contiguous (a row stride larger than S is allowed).  Returns
    ``(vals, C, log_ntl, log_sum_ll)`` as :func:`loo_prepass_plain` defines
    them; on the card vals and C are bitwise equal to the plain version and
    the two sums agree to float32 rounding (they are summed in another order).
    """
    _check(x, k)
    if x.device.type == "cpu":
        return loo_prepass_plain(x, k)
    device, ld, stream = _launch_args(x)
    b = x.shape[0]
    vals = torch.empty((b, k), dtype=x.dtype, device=x.device)
    c, log_ntl, log_sum_ll = torch.empty((3, b), dtype=x.dtype, device=x.device)
    if b == 0:
        return vals, c, log_ntl, log_sum_ll
    lib = _build.load()
    code = lib.pyloo_loo_prepass_f32(
        device, x.data_ptr(), b, x.shape[1], ld, k, vals.data_ptr(),
        c.data_ptr(), log_ntl.data_ptr(), log_sum_ll.data_ptr(), stream,
    )
    _raise_on(code, lib, "loo_prepass")
    loo_prepass.launches += 1
    return vals, c, log_ntl, log_sum_ll


loo_prepass.launches = 0


def loo_prepass_multi(x: torch.Tensor, k: int, parts: int):
    """:func:`loo_prepass` for S beyond one pass's cap, merged in torch.

    Splits the draw axis into ``parts`` slices of ``ceil(S / parts)`` (the
    last one narrower; views, no copy), runs the prepass on each and merges
    exactly, as ``pallas_loo_prepass_multi`` does:

    * top-k: each part returns the full k, so the top-k of the rebased
      concatenation is the global top-k (kernel B on the card);
    * row max: the max over parts; part values rebase by ``C_p - C``;
    * non-tail mass: each part's mass below its own cutoff, plus the part's
      top-k values between its cutoff and the merged cutoff, summed as one
      log-sum-exp (so a mass far below the row max does not flush to 0, as
      it does in ``pyloo_tpu``'s exp-domain sum).  The exclusion
      test runs in the part's own domain (bit-identical to the test the
      kernel made), the inclusion test in the merged domain, so a boundary
      element is neither dropped nor counted twice;
    * lppd: ``logaddexp`` across parts.
    """
    if parts < 2:
        return loo_prepass(x, k)
    s = x.shape[1]
    part_s = -(-s // parts)
    vals_p, c_p, ntl_p, ll_p = [], [], [], []
    for p in range(parts):
        v, c, ntl, ll = loo_prepass(x[:, p * part_s : (p + 1) * part_s], k)
        vals_p.append(v)
        c_p.append(c)
        ntl_p.append(ntl)
        ll_p.append(ll)

    c_all = torch.stack(c_p, dim=0)  # (parts, B)
    c_row = c_all.amax(dim=0)
    shifts = c_all - c_row[None, :]  # <= 0
    rebased = [v + shifts[p][:, None] for p, v in enumerate(vals_p)]

    from .selection import topk_vals_desc  # selection imports this module

    vals = topk_vals_desc(torch.cat(rebased, dim=1), k)
    xcut = torch.clamp_min(vals[:, k - 1], _CUTOFF_FLOOR)

    # non-tail mass as one logsumexp: pyloo_tpu sums it in the exp domain,
    # where a part's mass below e^-103 of the row max flushes to 0 in float32
    terms = [torch.stack([ntl_p[p] + shifts[p] for p in range(parts)], dim=1)]
    for p in range(parts):
        xcut_p = torch.clamp_min(vals_p[p][:, k - 1], _CUTOFF_FLOOR)
        between = (vals_p[p] > xcut_p[:, None]) & (rebased[p] <= xcut[:, None])
        terms.append(torch.where(between, rebased[p], -math.inf))
    log_ntl = logsumexp(torch.cat(terms, dim=1), dim=1)

    log_sum_ll = ll_p[0]
    for p in range(1, parts):
        log_sum_ll = torch.logaddexp(log_sum_ll, ll_p[p])
    return vals, c_row, log_ntl, log_sum_ll


# --------------------------------------------------------------------------
# Kernel B: exact top-k values
# --------------------------------------------------------------------------


def topk_desc_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of kernel B: the exact top-k values per row, descending."""
    return torch.topk(x, k, dim=1, sorted=True).values


def topk_desc(x: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel B: exact top-k values of each row of a float32 ``(B, S)`` tensor.

    Same input contract as :func:`loo_prepass`; returns ``(B, k)`` descending,
    bitwise equal to :func:`topk_desc_plain` as a multiset of values.
    """
    _check(x, k)
    if x.device.type == "cpu":
        return topk_desc_plain(x, k)
    device, ld, stream = _launch_args(x)
    b = x.shape[0]
    vals = torch.empty((b, k), dtype=x.dtype, device=x.device)
    if b == 0:
        return vals
    lib = _build.load()
    code = lib.pyloo_topk_desc_f32(
        device, x.data_ptr(), b, x.shape[1], ld, k, vals.data_ptr(), stream
    )
    _raise_on(code, lib, "topk_desc")
    topk_desc.launches += 1
    return vals


topk_desc.launches = 0
