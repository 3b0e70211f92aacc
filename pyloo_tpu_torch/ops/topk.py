"""Exact per-row top-k and the fused PSIS-LOO prepass: kernel wrappers.

Counterpart of ``pyloo_tpu/ops/pallas_topk.py``.  Hand-written CUDA kernels
for Hopper replace the TPU's Pallas kernels:

* kernel A, :func:`loo_prepass` — ``_kernel_fused`` (``pallas_loo_prepass``),
  in ``csrc/topk_prepass.cu``;
* kernel B, :func:`topk_desc` with ``variant="roll"`` — ``_kernel_roll``, a
  radix select in the same source (one templated kernel with the reductions
  switched on or off), whose selection scheme :func:`topk_radix_plain`
  follows step by step;
* kernels C and D, :func:`topk_desc` with ``variant="reshape"`` and
  ``"natural"`` — ``_kernel`` and ``_kernel_natural``, bitonic sorting
  networks over 256-wide segments, in ``csrc/topk_bitonic.cu``.  The TPU
  kernels merge the sorted segments as a tree
  (:func:`topk_desc_reshape_plain`, :func:`topk_desc_natural_plain`); the
  CUDA kernels fold them one after another into a running top 256
  (:func:`topk_desc_reshape_fold_plain`, :func:`topk_desc_natural_fold_plain`).

Each wrapper launches its kernel for a CUDA tensor on that tensor's device
and its current stream (the caller's current device is left as it was),
counts the launch in its ``launches`` attribute (for :func:`topk_desc`, a
dict keyed by variant) and per device in ``by_device`` (keyed by the
device's name, ``"cuda:1"``; for :func:`topk_desc`, by variant and then
device), and raises when the kernel does not take the input.  For a tensor on the CPU it
returns its plain PyTorch version (:func:`loo_prepass_plain`,
:func:`topk_desc_plain`, :func:`topk_desc_reshape_plain`,
:func:`topk_desc_natural_plain`), which the CPU tests compare with the JAX
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
    "candidate_cap",
    "topk_radix_plain",
    "overflow_rows",
    "blocks_per_sm",
    "bitonic_blocks_per_sm",
    "BITONIC_MAX_K",
    "TOPK_VARIANTS",
    "topk_desc",
    "topk_desc_plain",
    "topk_desc_reshape_plain",
    "topk_desc_natural_plain",
    "topk_desc_reshape_fold_plain",
    "topk_desc_natural_fold_plain",
]

# One block holds one row in shared memory: (S + 1024) float32 must fit the
# 227 KB a block may use on an H100.  32768 draws (132 KB) keeps that margin
# and covers every PSIS tail of S <= 32768 (k = 3 sqrt(S) + 1 <= 545).
# Must equal kMaxS / kMaxK in csrc/topk_prepass.cu (which refuses larger).
MAX_S = 32768
MAX_K = 1024
# Kernels C and D keep each 256-wide segment's top 256, so k <= 256 (the TPU
# kernels' list height); their S cap is MAX_S, as for A and B.  Must equal
# kMaxK / kMaxS in csrc/topk_bitonic.cu.
_SEG = 256
BITONIC_MAX_K = _SEG
# Segments a warp of kernels C and D sorts at once, each folded into a running
# top 256 of its own.  Must equal kGroups in csrc/topk_bitonic.cu.
_FOLD_GROUPS = 2
TOPK_VARIANTS = ("roll", "reshape", "natural")
# log(float64 tiny): the reference's tail-cutoff floor (pyloo psis.py:90)
_CUTOFF_FLOOR = float(math.log(2.2250738585072014e-308))
_OVERFLOW: dict = {}  # device -> uint32 count of rows that overflowed the first digit


def candidate_cap(k: int) -> int:
    """Slots of kernels A and B's candidate buffer for this k: the keys in
    and above the k-th key's bin go there, and a row with more narrows the
    bin by a further digit first.  Must equal ``cand_cap`` in
    csrc/topk_prepass.cu (1536, and P / 2 more slots when the sort takes
    P > 256, P the power of two >= max(k, 32))."""
    p = 32
    while p < k:
        p *= 2
    return 1536 + (p // 2 if p > 256 else 0)


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


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    return device


def _overflow_counter(device) -> torch.Tensor:
    device = _cuda_device(device)
    if device not in _OVERFLOW:
        _OVERFLOW[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _OVERFLOW[device]


def overflow_rows(device="cuda", reset: bool = False) -> int:
    """Rows that kernels A and B narrowed by a further digit (one more pass
    over the row) because more than :func:`candidate_cap` keys lay in or
    above the k-th key's first-digit bin, counted on
    ``device`` since the last reset.  Reads the device counter (a
    synchronisation); ``reset`` sets it to 0 afterwards."""
    counter = _overflow_counter(device)
    n = int(counter.item())
    if reset:
        counter.zero_()
    return n


def blocks_per_sm(s: int, k: int, fused: bool = True, device="cuda") -> int:
    """Resident blocks a SM of kernel A (``fused``) or B at rows of S, k."""
    lib = _build.load()
    n = lib.pyloo_prepass_blocks_per_sm(_cuda_device(device).index, int(fused), s, k)
    if n < 0:
        _raise_on(-n, lib, "occupancy query of the prepass")
    return n


def bitonic_blocks_per_sm(variant: str, device="cuda") -> int:
    """Resident blocks (of four warps) a SM of kernel C (``"reshape"``) or D
    (``"natural"``), as built for rows that start on 16-byte boundaries."""
    lib = _build.load()
    n = lib.pyloo_bitonic_blocks_per_sm(_cuda_device(device).index, int(variant == "natural"))
    if n < 0:
        _raise_on(-n, lib, "occupancy query of the bitonic top-k")
    return n


def _count_on(by_device: dict, device: torch.device) -> None:
    """One launch more on ``device`` in a wrapper's per-device counts."""
    name = str(_cuda_device(device))
    by_device[name] = by_device.get(name, 0) + 1


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
        c.data_ptr(), log_ntl.data_ptr(), log_sum_ll.data_ptr(),
        _overflow_counter(x.device).data_ptr(), stream,
    )
    _raise_on(code, lib, "loo_prepass")
    loo_prepass.launches += 1
    _count_on(loo_prepass.by_device, x.device)
    return vals, c, log_ntl, log_sum_ll


loo_prepass.launches = 0
loo_prepass.by_device = {}


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
# Kernels B, C and D: exact top-k values
# --------------------------------------------------------------------------


def topk_desc_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of kernel B: the exact top-k values per row, descending."""
    return torch.topk(x, k, dim=1, sorted=True).values


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """The kernels' order-preserving uint32 key of float32 values, as int64."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2**31, 0xFFFFFFFF - u, u | 2**31)


def _key_value(key: torch.Tensor) -> torch.Tensor:
    u = torch.where(key >= 2**31, key & 0x7FFFFFFF, 0xFFFFFFFF - key)
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)


def _find_bin(counts: torch.Tensor, rank: torch.Tensor):
    """Per row of a ``(B, bins)`` histogram: the bin, counted from the top,
    that holds the rank-th largest key; the rank within it; its count."""
    from_top = counts.flip(1).cumsum(1)
    # clamped: a row that takes no part in this digit may hold fewer keys
    # than its rank, and what this returns for it is not used
    j = (from_top < rank[:, None]).sum(1, keepdim=True).clamp_max(counts.shape[1] - 1)
    bins = counts.shape[1] - 1 - j
    in_bin = counts.gather(1, bins)
    above = from_top.gather(1, j) - in_bin
    return bins[:, 0], rank - above[:, 0], in_bin[:, 0]


def _digit(src, member, edge, lo, s, krem, active):
    """One radix digit, bits ``s`` to ``lo - 1``, of the keys ``src`` where
    ``member`` holds and that lie in the bin ``[edge, edge + 2^lo)``, on the
    ``active`` rows: their histogram, the bin of the krem-th largest key in
    it, added to ``edge``.  Returns ``(edge, krem, count)``, the count of keys
    in the new bin (``lo``, ``s`` per row; the other rows pass through)."""
    in_bin = member & ((src >> lo[:, None]) == (edge >> lo)[:, None])
    digit = torch.where(in_bin, (src >> s[:, None]) & ((1 << (lo - s)) - 1)[:, None], 0)
    hist = torch.zeros(src.shape[0], 4096, dtype=torch.int64, device=src.device)
    hist.scatter_add_(1, digit, in_bin.to(torch.int64))
    b, r, count = _find_bin(hist, krem)
    return torch.where(active, edge | (b << s), edge), torch.where(active, r, krem), count


def topk_radix_plain(x: torch.Tensor, k: int):
    """Kernel B's selection, step by step, in tensor ops: ``(vals, refined)``.

    1. a histogram of the first digit, the top 12 bits of each key, and the
       bin of the k-th key;
    2. while the keys in and above that bin are more than the candidate
       buffer's :func:`candidate_cap` slots, the next digit of the keys in
       the bin (12 bits, then the last 8) narrows it: ``refined`` rows, each
       digit one more pass over the row in the kernels;
    3. the candidates, the keys in and above the bin, go to the buffer (when
       a tie run is longer than the buffer, only the keys above the k-th
       key);
    4. the bin's remaining digits, 10 bits at most each, over the buffer's
       keys in the bin give the exact k-th key;
    5. the keys above it are the winners, the k-th key fills the remaining
       slots, and the winners are sorted descending.

    ``vals`` equals ``torch.topk(x, k).values`` value for value (the keys
    order -0.0 below +0.0; the two compare equal, so which zero fills a
    tied slot may differ).  Kernel A selects the same way on the raw row and
    returns ``vals - C``.
    """
    b = x.shape[0]
    key = _order_key(x)
    cap = candidate_cap(k)
    every = torch.ones_like(key, dtype=torch.bool)
    full = lambda v: torch.full((b,), v, dtype=torch.int64, device=x.device)  # noqa: E731
    edge, krem, count = _digit(key, every, full(0), full(32), full(20), full(k), every[:, 0])
    lo = full(20)
    refined = ~every[:, 0]
    for s in (8, 0):
        active = k - krem + count > cap
        refined |= active
        s_row = torch.where(active, s, lo)
        edge, krem, count_s = _digit(key, every, edge, lo, s_row, krem, active)
        count = torch.where(active, count_s, count)
        lo = s_row
    ties_out = k - krem + count > cap
    take_from = torch.where(ties_out, edge + 1, edge)
    n_c = k - krem + torch.where(ties_out, 0, count)

    # the candidate buffer: the keys >= take_from, moved to the front
    is_cand = key >= take_from[:, None]
    order = torch.argsort((~is_cand).to(torch.int8), dim=1, stable=True)[:, :cap]
    buf = key.gather(1, order)
    in_buf = torch.arange(buf.shape[1], device=x.device)[None, :] < n_c[:, None]
    kth = edge
    while bool((lo > 0).any()):
        s = torch.clamp_min(lo - 10, 0)
        kth, krem, _ = _digit(buf, in_buf, kth, lo, s, krem, lo > 0)
        lo = s

    top = torch.sort(torch.where(key > kth[:, None], key, -1), dim=1, descending=True).values[:, :k]
    n_gt = k - krem
    top = torch.where(torch.arange(k, device=x.device)[None, :] < n_gt[:, None], top, kth[:, None])
    return _key_value(top), refined


def _sorted_segments(x: torch.Tensor, natural: bool) -> torch.Tensor:
    """``(B, n_segs, 256)``: the row padded with -inf to a power of two of
    256-wide segments, each sorted descending (odd ones ascending if
    ``natural``)."""
    b, s = x.shape
    n_segs = 1
    while n_segs * _SEG < s:
        n_segs *= 2
    x = torch.nn.functional.pad(x, (0, n_segs * _SEG - s), value=-math.inf)
    v = torch.sort(x.reshape(b, n_segs, _SEG), dim=-1, descending=True).values
    if natural:
        v[:, 1::2] = v[:, 1::2].flip(-1)
    return v


def _bitonic_merge_desc(v: torch.Tensor) -> torch.Tensor:
    """Sort bitonic 256-lists (last axis) descending: 8 half-cleaner stages."""
    shape = v.shape
    stride = _SEG // 2
    while stride >= 1:
        w = v.reshape(*shape[:-1], _SEG // (2 * stride), 2, stride)
        hi = torch.maximum(w[..., 0, :], w[..., 1, :])
        lo = torch.minimum(w[..., 0, :], w[..., 1, :])
        v = torch.stack([hi, lo], dim=-2).reshape(shape)
        stride //= 2
    return v


def topk_desc_reshape_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of kernel C, in its merge scheme: ``torch.sort`` of the
    256-wide segments, then rounds of ``max(A_i, B_{255-i})`` (``flip``) over
    segment pairs, each re-sorted by a bitonic half-cleaner network."""
    v = _sorted_segments(x, natural=False)
    while v.shape[1] > 1:
        v = _bitonic_merge_desc(torch.maximum(v[:, 0::2], v[:, 1::2].flip(-1)))
    return v[:, 0, :k]


def topk_desc_natural_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of kernel D, in its merge scheme: segments sorted in
    alternating directions, rounds of ``max(A_i, B_i)`` with no reversal,
    each survivor re-sorted in the direction of its parity in the next round
    (a half-cleaner sorts descending; ascending is its reversal)."""
    v = _sorted_segments(x, natural=True)
    while v.shape[1] > 1:
        v = _bitonic_merge_desc(torch.maximum(v[:, 0::2], v[:, 1::2]))
        v[:, 1::2] = v[:, 1::2].flip(-1)
    return v[:, 0, :k]


def _fold_plain(x: torch.Tensor, k: int, natural: bool) -> torch.Tensor:
    """The merge order of the CUDA kernels C and D in tensor ops: the row in
    ``ceil(S / 256)`` segments (the last filled with -inf), segment ``j``
    folded into the running top 256 of group ``j % _FOLD_GROUPS`` by one
    max-merge (against the reversed segment for C, against the segment
    sorted ascending for D) and the half-cleaner, and at the end the groups'
    survivors merged in pairs, the partner reversed."""
    b, s = x.shape
    span = _FOLD_GROUPS * _SEG
    n_iter = -(-s // span)
    x = torch.nn.functional.pad(x, (0, n_iter * span - s), value=-math.inf)
    segs = torch.sort(x.reshape(b, n_iter, _FOLD_GROUPS, _SEG), dim=-1, descending=not natural).values
    top = torch.full((b, _FOLD_GROUPS, _SEG), -math.inf, dtype=x.dtype, device=x.device)
    for it in range(n_iter):
        seg = segs[:, it]
        top = _bitonic_merge_desc(torch.maximum(top, seg if natural else seg.flip(-1)))
    while top.shape[1] > 1:
        top = _bitonic_merge_desc(torch.maximum(top[:, 0::2], top[:, 1::2].flip(-1)))
    return top[:, 0, :k]


def topk_desc_reshape_fold_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel C's scheme in the CUDA kernel's merge order (:func:`_fold_plain`);
    value for value what :func:`topk_desc_reshape_plain` returns."""
    return _fold_plain(x, k, natural=False)


def topk_desc_natural_fold_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel D's scheme in the CUDA kernel's merge order (:func:`_fold_plain`);
    value for value what :func:`topk_desc_natural_plain` returns."""
    return _fold_plain(x, k, natural=True)


_TOPK_PLAIN = {
    "roll": topk_desc_plain,
    "reshape": topk_desc_reshape_plain,
    "natural": topk_desc_natural_plain,
}
_TOPK_ENTRY = {
    "roll": "pyloo_topk_desc_f32",
    "reshape": "pyloo_topk_reshape_f32",
    "natural": "pyloo_topk_natural_f32",
}


def _check_variant(variant: str, k: int) -> None:
    if variant not in _TOPK_ENTRY:
        raise ValueError(f"unknown top-k variant {variant!r}; expected one of {TOPK_VARIANTS}")
    if variant != "roll" and k > BITONIC_MAX_K:
        raise ValueError(f"variant {variant!r} supports only k <= {BITONIC_MAX_K}; use 'roll'")


def _topk_prepare(x: torch.Tensor, k: int):
    """What :func:`topk_desc` does on the host before a launch: the launch
    arguments and the output.  Returns ``(device, ld, stream, vals)``."""
    device, ld, stream = _launch_args(x)
    vals = torch.empty((x.shape[0], k), dtype=x.dtype, device=x.device)
    return device, ld, stream, vals


def _topk_launch(variant: str, x: torch.Tensor, k: int, prepared) -> None:
    """Launch one top-k kernel on prepared arguments (counts nothing)."""
    device, ld, stream, vals = prepared
    lib = _build.load()
    counter = [_overflow_counter(x.device).data_ptr()] if variant == "roll" else []
    code = getattr(lib, _TOPK_ENTRY[variant])(
        device, x.data_ptr(), x.shape[0], x.shape[1], ld, k, vals.data_ptr(), *counter, stream
    )
    _raise_on(code, lib, f"topk_desc({variant})")


def topk_desc(x: torch.Tensor, k: int, variant: str = "roll") -> torch.Tensor:
    """Exact top-k values of each row of a float32 ``(B, S)`` tensor.

    ``variant`` picks the kernel, as in ``pallas_topk_desc``: ``"roll"`` is
    kernel B (radix select, k <= 1024), ``"reshape"`` kernel C and
    ``"natural"`` kernel D (bitonic networks over 256-wide segments, k <=
    256, S <= 32768).  Same input contract as
    :func:`loo_prepass`; returns ``(B, k)`` descending, bitwise equal to
    ``torch.topk`` as a multiset of values.  Launches are counted in
    ``topk_desc.launches[variant]``.
    """
    _check(x, k)
    _check_variant(variant, k)
    if x.device.type == "cpu":
        return _TOPK_PLAIN[variant](x, k)
    prepared = _topk_prepare(x, k)
    if x.shape[0] == 0:
        return prepared[3]
    _topk_launch(variant, x, k, prepared)
    topk_desc.launches[variant] += 1
    _count_on(topk_desc.by_device[variant], x.device)
    return prepared[3]


topk_desc.launches = dict.fromkeys(TOPK_VARIANTS, 0)
topk_desc.by_device = {variant: {} for variant in TOPK_VARIANTS}
