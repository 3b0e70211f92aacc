"""Validation sweep of the port's kernels and exact programs, on the card.

Port of ``scripts/validate_pallas_tpu.py``.  The CPU tests hold the plain
versions to ``pyloo_tpu``; this tool holds the CUDA kernels and the float64
programs as they run on the card, in seven sections:

* ``topk`` -- kernels B, C and D (``topk_desc``, variants ``roll``,
  ``reshape``, ``natural``): values bitwise equal to their plain versions
  and to ``torch.topk`` after ``positive_nan``, C and D also to the TPU
  kernels' tree order and the CUDA kernels' fold order; B's selection scheme
  (``topk_radix_plain``) equal to them too, and the rows B narrowed by a
  further digit equal to the scheme's.
* ``prepass`` -- kernel A (``loo_prepass``): ``vals`` and ``C`` bitwise equal
  to ``loo_prepass_plain``, ``log_ntl`` and ``log_sum_ll`` within
  :data:`SUM_RTOL` / :data:`SUM_ATOL` of it; on rows with no value that is
  not finite, the two sums within :data:`ORACLE_TOL` of the TPU script's
  float64 formulas; its overflow rows equal to the scheme's.
* ``multi`` -- kernel A over draw-axis parts (``loo_prepass_multi``, beyond
  one pass's ``MAX_S`` and with parts barely wider than k) and kernel B's
  merge, against one pass of the plain version over the whole row; each
  part (a view at its column) bitwise to the plain version.
* ``exact`` -- float64 ``psislw`` against :mod:`.oracle` at :data:`EXACT_TOL`.
* ``eloo`` -- the weighted mean, variance and quantile against float64
  NumPy at :data:`ELOO_TOL`, and ``khat_batch`` against the same function
  on the CPU.
* ``nonfactor`` -- MVN / MVT conditional log-likelihoods against
  brute-force partitioned-normal / direct-formula NumPy at
  :data:`NONFACTOR_TOL`.
* ``mm`` -- the device-batched moment-matching program against the host
  greedy loop on a fitted outlier model at :data:`MM_TOL`, split and not.

The kernel sections run over the card's edges (:data:`S_EDGES`,
:data:`K_TIERS`, :data:`BATCHES`, views at :data:`VIEW_COLS`), the TPU
script's shapes mapped onto the card's envelope, the PSIS tail's k at
several ``reff`` (:data:`REFF_TAILS`), and six input families
(:data:`FAMILIES`).  A view's padding is NaN, so a read outside the row
shows.

Run, from the root of the repository::

    python3 -m pyloo_tpu_torch.tools.validate_kernels [section ...]
        [--device cuda|cpu] [--out PATH]

It runs on the card (``cuda``) and exits 2 where torch finds none; only an
explicit ``--device cpu`` runs it on the CPU, where each kernel wrapper
returns its plain version and every record says ``"platform": "cpu"``.  One
JSON record a case goes to ``--out`` (``build/validate_kernels.json``), a
summary line a section to standard output; any failed case exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import warnings

import numpy as np
import torch

from ..ops import topk
from ..ops.psis import tail_length
from ..ops.selection import fast_path_route
from ._harness import (card_of, finite_err, nan_equal, on_device, platform_of,
                       resolve_device, sync)

SECTIONS = ("topk", "prepass", "multi", "exact", "eloo", "nonfactor", "mm")
SEED = 20260818  # the inputs of every case

# Kernel A's two sums against its plain version: the same float32 terms
# summed in another order (chip_smoke.py's hold_prepass)
SUM_RTOL, SUM_ATOL = 2e-6, 1e-6
# Kernel A's two sums against the TPU script's formulas in float64: its
# prepass tolerance (float32 terms summed against float64 arithmetic), and
# relative to the sum, the float32 rounding of the kernel's last addition
# (xcut + log(mass), -min + log(mass))
ORACLE_TOL = 1e-4
EPS32 = float(np.finfo(np.float32).eps)
# loo_prepass_multi against one pass: the rebase of a part by (C_p - C)
# adds one float32 rounding whose size scales with the row's values (the
# TPU script's multipass bound, this many float32 epsilons of the row's
# largest finite |x|), on top of kernel A's own summation order
MULTI_ULPS = 8.0
EXACT_TOL = 1e-8  # float64 PSIS against the NumPy oracle
ELOO_TOL = 1e-8  # weighted moments and quantiles against NumPy float64
NONFACTOR_TOL = 1e-7  # conditional log-likelihoods against brute force
MM_TOL = 1e-8  # device-batched moment matching against the host loop

# The card's edges.  S: below, at and past a warp's 32 lanes, not a multiple
# of 4, one past and one short of a 256-wide segment, one pass's cap.  k:
# each sort tier P = 32 ... 1024 and its neighbours (capped at S).  B: below,
# at and past a block's four warps, and wide batches.
S_EDGES = (2, 7, 31, 32, 33, 100, 255, 257, 1_001, 4_000, 4_003, 32_767, 32_768)
K_TIERS = (1, 31, 32, 33, 64, 65, 255, 256, 257, 511, 512, 513, 1_023, 1_024)
BATCHES = (1, 3, 4, 5, 9, 1_024, 4_099)
# column of the view (0: contiguous rows; else rows VIEW_PAD longer than S)
VIEW_COLS = (0, 1, 2, 3)
VIEW_PAD = 7
FAMILIES = ("normal", "adversarial", "ties at k", "overflow", "concentrated", "edge")
# the PSIS tail's k = tail_length(S, reff) + 1
REFF_TAILS = tuple((s, reff) for s in (1_000, 4_000, 16_000) for reff in (1.0, 0.3, 0.1))
# the TPU script's (S, k) (validate_pallas_tpu.py:58-95) within one pass
TPU_SHAPES = ((200, 1), (256, 191), (300, 255), (512, 256), (2_000, 191), (4_000, 191),
              (4_096, 256), (4_097, 100), (8_000, 270), (8_192, 512), (16_000, 191),
              (16_384, 257), (513, 512), (1_025, 1_024), (256, 192), (2_000, 192),
              (4_000, 192), (16_000, 192))
# beyond one pass: (S, k, B, family); the TPU script's 1024-tall and
# multipass shapes, one past the cap, the PSIS tail at 80,000 draws, and
# sixteen parts
MULTI_SHAPES = ((32_769, 192, 16, "tpu prepass"), (33_000, 513, 3, "edge"),
                (40_000, 600, 512, "tpu prepass"), (65_536, 770, 16, "overflow"),
                (65_536, 1_024, 1, "ties at k"), (80_000, 849, 512, "edge"),
                (100_000, 608, 16, "tpu prepass"), (131_072, 770, 5, "concentrated"),
                (200_000, 192, 512, "tpu prepass"), (524_288, 1_024, 3, "adversarial"))
# parts barely wider than k: S = parts (k + 1) - 1, the last part k wide
NARROW_PARTS = ((2_049, 1_024, 2), (770, 256, 3), (127, 31, 4), (31, 1, 16), (1_025, 512, 2))


# --------------------------------------------------------------------------
# input families (x = -log_lik rows, float32)
# --------------------------------------------------------------------------


def _ranks(b: int, s: int, gen, device):
    """A random permutation of the columns of each row, as ranks 0..s-1."""
    order = torch.rand(b, s, generator=gen, device=device).argsort(dim=1)
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(s, device=device).expand(b, s).contiguous())
    return ranks


def adversarial_rows(b: int, s: int, gen, device):
    """The TPU script's adversarial family (validate_pallas_tpu.py:98-111):
    normal rows, and in rows 0-5 tie runs across 256-wide segments (one
    value repeated in another segment), an all-equal row, a row of -inf, a
    half -inf row, a t(2) tail and one dominant draw."""
    x = torch.randn(b, s, generator=gen, device=device)
    wide = s >= 600
    a0, a1 = (200, 300) if wide else (s // 4, max(s // 2, s // 4 + 1))
    c0 = 500 if wide else 3 * s // 4
    c1 = 520 if wide else c0 + max(1, s // 20)
    put = [
        lambda r: (r.__setitem__(slice(a0, a1), 2.0), r.__setitem__(slice(c0, c1), 3.0)),
        lambda r: r.fill_(0.25),
        lambda r: r.fill_(-math.inf),
        lambda r: r.__setitem__(slice(None, s // 2), -math.inf),
        lambda r: r.copy_(-3.0 * _student_t2(s, gen, device).abs()),
        lambda r: r.__setitem__(s - 1, 100.0),
    ]
    for i in range(min(b, len(put))):
        put[i](x[i])
    return x


def _student_t2(n: int, gen, device):
    z = torch.randn(3, n, generator=gen, device=device)
    return z[0] / torch.sqrt(z[1:].square().sum(dim=0) / 2.0)


def ties_rows(b: int, s: int, k: int, gen, device):
    """Ties at the k-th place, by row in turn: a run of 7 equal values
    around it; a run of ``topk.candidate_cap(k) + 5`` equal values there, above
    which only k // 2 values lie (longer than the candidate buffer); a row of
    one value but for k - 1 above it."""
    x = torch.rand(b, s, generator=gen, device=device) - 1.0
    ranks = _ranks(b, s, gen, device)
    kind = torch.arange(b, device=device) % 3
    n_hi = torch.where(kind == 0, max(k - 4, 0), torch.where(kind == 1, k // 2, k - 1))
    n_tie = torch.where(kind == 0, 7, torch.where(kind == 1, topk.candidate_cap(k) + 5, s))
    hi = ranks < n_hi[:, None]
    tie = ~hi & (ranks < (n_hi + n_tie)[:, None])
    x = torch.where(hi, 2.0 + torch.rand(b, s, generator=gen, device=device), x)
    return torch.where(tie, torch.where(kind[:, None] == 2, 0.5, 1.0), x)


def overflow_rows(b: int, s: int, k: int, gen, device):
    """More than ``candidate_cap(k)`` keys in the k-th key's bin, by row in
    turn: every value in one first-digit bin (x in [1, 1.125)); every value
    in one bin down to the last digit (x = 1 + m 2^-23, m < 256: long tie
    runs); k // 2 values far above and the rest in one first-digit bin."""
    m = torch.randint(0, 2**20, (b, s), generator=gen, device=device)
    kind = torch.arange(b, device=device)[:, None] % 3
    m = torch.where(kind == 1, m % 256, m)
    x = 1.0 + m.float() * 2.0**-23
    far = (kind == 2) & (_ranks(b, s, gen, device) < k // 2)
    return torch.where(far, 4.0 + torch.rand(b, s, generator=gen, device=device), x)


def edge_rows(b: int, s: int, k: int, gen, device):
    """``(b, s)`` rows whose first rows are the edge kinds of
    ``chip_smoke.py``'s phase 14 (this tool's own copy, for any s >= 1), the
    rest normal draws: NaN of either sign and other bit patterns, one or
    many to a row, k - 1, k and k + 1 of them, a row of NaN; +inf and -inf
    entries and rows; one finite value among -inf and among +inf;
    subnormals; +-FLT_MAX; +-0.0 at the k-th place.  Returns ``(x, names)``,
    the names of the kinds that fit in b rows."""
    big = torch.finfo(torch.float32).max
    tiny = torch.finfo(torch.float32).smallest_normal * 2.0**-23  # the least subnormal
    x = 1.0 + 0.8 * torch.randn(b, s, generator=gen, device=device)
    pat = torch.from_numpy(np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                                    np.uint32).view(np.float32)).to(device)
    nan, neg_nan, nan_low, neg_nan_ones = pat  # 0-d tensors: assigned bit for bit
    inf = math.inf
    mid, third, seven = s // 2, s // 3, min(7, s - 1)

    def cols(n):  # min(n, s) distinct columns
        return torch.randperm(s, generator=gen, device=device)[: max(0, min(n, s))]

    def uniform(n, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)

    def randint(lo, hi):
        return torch.randint(lo, hi, (s,), generator=gen, device=device).float()

    def put_cols(r, n, value):
        r[cols(n)] = value

    def zeros_at_k(r):
        r.copy_(torch.where(uniform(s) < 0.5, 0.0, -0.0))
        idx = cols(k - 1)
        r[idx] = 0.1 + uniform(len(idx))
        r[::29] = -1.0

    rows = [
        ("one NaN", lambda r: r.__setitem__(third, nan)),
        ("one -NaN", lambda r: r.__setitem__(seven, neg_nan)),
        ("NaN every 7th", lambda r: r.__setitem__(slice(None, None, 7), nan)),
        ("-NaN every 11th", lambda r: r.__setitem__(slice(3, None, 11), neg_nan)),
        ("k - 1 -NaN", lambda r: put_cols(r, k - 1, neg_nan)),
        ("k NaN", lambda r: put_cols(r, k, nan)),
        ("k + 1 -NaN", lambda r: put_cols(r, k + 1, neg_nan)),
        ("NaN bit patterns", lambda r: (r.__setitem__(slice(None, None, 13), nan_low),
                                        r.__setitem__(slice(5, None, 13), neg_nan_ones))),
        ("-NaN in every other", lambda r: r.__setitem__(slice(None, None, 2), neg_nan)),
        ("a row of NaN", lambda r: r.fill_(math.nan)),
        ("a row of -NaN", lambda r: r.copy_(neg_nan.expand(s))),
        ("NaN, +inf and -inf", lambda r: (r.__setitem__(slice(None, None, 3), nan),
                                          r.__setitem__(slice(1, None, 3), inf),
                                          r.__setitem__(slice(2, None, 5), -inf))),
        ("+inf every 9th", lambda r: r.__setitem__(slice(None, None, 9), inf)),
        ("k - 1 +inf", lambda r: put_cols(r, k - 1, inf)),
        ("2k +inf", lambda r: put_cols(r, 2 * k, inf)),
        ("a row of +inf", lambda r: r.fill_(inf)),
        ("-inf every 5th", lambda r: r.__setitem__(slice(None, None, 5), -inf)),
        ("a row of -inf", lambda r: r.fill_(-inf)),
        ("one finite among -inf", lambda r: (r.fill_(-inf), r.__setitem__(mid, 0.5))),
        ("one finite among +inf", lambda r: (r.fill_(inf), r.__setitem__(mid, 0.5))),
        ("subnormals", lambda r: r.copy_(tiny * randint(-100, 100))),
        ("subnormals and normals", lambda r: r.__setitem__(slice(None, None, 2),
                                                           (tiny * randint(-100, 100))[::2])),
        ("+-FLT_MAX", lambda r: (r.copy_(big * uniform(s, -1.0, 1.0)),
                                 r.__setitem__(0, big), r.__setitem__(-1, -big))),
        ("+-FLT_MAX and +inf", lambda r: (r.__setitem__(slice(None, None, 2), big),
                                          r.__setitem__(slice(1, None, 2), -big),
                                          r.__setitem__(slice(None, None, 17), inf))),
        ("+-0.0 at the k-th place", zeros_at_k),
        ("-0.0 below k - 1 +0.0", lambda r: (r.fill_(-0.0), put_cols(r, k - 1, 0.0))),
    ]
    for i, (_, put) in enumerate(rows[:b]):
        put(x[i])
    return x, [name for name, _ in rows[:b]]


def tpu_prepass_rows(b: int, s: int, gen, device):
    """The TPU script's prepass rows: x = -log_lik, log_lik ~ N(-1, 0.8),
    row 3 (or the last) a t(2) tail, -3 |t|."""
    ll = -1.0 + 0.8 * torch.randn(b, s, generator=gen, device=device)
    ll[min(3, b - 1)] = -3.0 * _student_t2(s, gen, device).abs()
    return -ll


def family_rows(family: str, b: int, s: int, k: int, gen, device):
    """``(b, s)`` float32 rows of one input family."""
    if family == "normal":
        return 1.0 + 0.8 * torch.randn(b, s, generator=gen, device=device)
    if family == "concentrated":
        return 0.7 + 0.01 * torch.randn(b, s, generator=gen, device=device)
    if family == "adversarial":
        return adversarial_rows(b, s, gen, device)
    if family == "ties at k":
        return ties_rows(b, s, k, gen, device)
    if family == "overflow":
        return overflow_rows(b, s, k, gen, device)
    if family == "edge":
        return edge_rows(b, s, k, gen, device)[0]
    if family == "tpu prepass":
        return tpu_prepass_rows(b, s, gen, device)
    raise ValueError(f"unknown family {family!r}")


def as_view(x: torch.Tensor, col: int) -> torch.Tensor:
    """``x`` at column ``col`` of rows ``VIEW_PAD`` longer, the padding NaN
    (col 0: ``x`` itself, contiguous)."""
    if col == 0:
        return x
    b, s = x.shape
    base = torch.full((b, s + VIEW_PAD), math.nan, dtype=x.dtype, device=x.device)
    base[:, col : col + s] = x
    return base[:, col : col + s]


# --------------------------------------------------------------------------
# the cases of the kernel sections
# --------------------------------------------------------------------------


def grid_cases(max_k: int) -> list:
    """``(S, k, B, col, family)`` for a kernel that takes k <= max_k: every
    S of :data:`S_EDGES` with every k of :data:`K_TIERS` capped at S, the
    batches, columns and families taken in turn; the TPU script's shapes
    (B 9 and 1,024, adversarial); the PSIS tail's k at each of
    :data:`REFF_TAILS`; rows that overflow the candidate buffer at the
    least S that can (k 1, 256, 257, 513, 1,024) and at the main path's
    shapes; ties, edge rows and views at the largest tiers."""
    cases, i = [], 0
    for s in S_EDGES:
        for k in sorted({min(k, s) for k in K_TIERS}):
            if k <= max_k:
                cases.append((s, k, BATCHES[i % len(BATCHES)], VIEW_COLS[i % len(VIEW_COLS)],
                              FAMILIES[i % len(FAMILIES)]))
                i += 1
    for s, k in TPU_SHAPES:
        if k <= max_k:
            cases += [(s, k, 9, 0, "adversarial"), (s, k, 1_024, 0, "adversarial")]
    for j, (s, reff) in enumerate(REFF_TAILS):
        k = tail_length(s, reff) + 1
        if k <= max_k:
            cases.append((s, k, 1_024, VIEW_COLS[j % len(VIEW_COLS)],
                          ("normal", "edge", "concentrated")[j % 3]))
    for j, k in enumerate((1, 256, 257, 513, 1_024)):
        if k <= max_k:
            cases.append((topk.candidate_cap(k) + 1, k, (3, 64)[j % 2], j % 2, "overflow"))
    for s, k, b, col, family in ((4_000, 191, 1_024, 0, "overflow"),
                                 (4_000, 601, 5, 3, "overflow"),
                                 (32_768, 545, 64, 1, "overflow"),
                                 (4_000, 191, 1_024, 2, "ties at k"),
                                 (2_000, 513, 3, 0, "ties at k"),
                                 (32_768, 1_024, 64, 0, "ties at k"),
                                 (4_000, 191, 1_024, 0, "edge"),
                                 (32_768, 256, 64, 3, "edge"),
                                 (32_768, 1_024, 64, 2, "edge"),
                                 (100, 33, 32, 1, "edge"),
                                 (2, 1, 5, 2, "edge")):
        if k <= max_k:
            cases.append((s, k, b, col, family))
    return cases


class Run:
    """The records of one run: the device, its platform and card, and
    what each case found."""

    def __init__(self, device: torch.device, seed: int):
        self.device = device
        self.platform = platform_of(device)
        self.card = card_of(device)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.rng = np.random.default_rng(seed)
        self.records: list = []

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def record(self, section: str, kernel: str, passed: bool, max_abs_diff: float,
               **fields) -> dict:
        rec = {"section": section, "kernel": kernel, **fields, "platform": self.platform,
               "card": self.card, "pass": bool(passed), "max_abs_diff": float(max_abs_diff)}
        self.records.append(rec)
        if not passed:
            print(f"  FAIL  {json.dumps(rec)}", flush=True)
        return rec

    def summary(self, section: str, t0: float) -> bool:
        mine = [r for r in self.records if r["section"] == section]
        failed = sum(not r["pass"] for r in mine)
        kernels = sorted({r["kernel"] for r in mine})
        diff = max((r["max_abs_diff"] for r in mine), default=0.0)
        print(f"{section}: {len(mine)} cases, {failed} failed ({', '.join(kernels)}), max |diff|"
              f" {diff:.3g}, {time.perf_counter() - t0:.1f} s on {self.platform}"
              f" ({self.card or 'no card'})", flush=True)
        return failed == 0


def _overflow_count(run: Run, reset_only: bool = False) -> int | None:
    """Kernels A and B's count of rows narrowed by a further digit since the
    last read (None on the CPU, which has no counter)."""
    if not run.on_card:
        return None
    n = topk.overflow_rows(run.device, reset=True)
    return None if reset_only else n


def _plain_overflow(x: torch.Tensor, k: int, skip_nan_rows: bool) -> int:
    """Rows the kernels' selection scheme narrows by a further digit;
    kernel A selects on no row that holds a NaN."""
    _, refined = topk.topk_radix_plain(x, k)
    if skip_nan_rows:
        refined = refined & ~torch.isnan(x).any(dim=1)
    return int(refined.sum())


def hold_b(run: Run, x, k: int, meta: dict) -> None:
    """Kernel B: bitwise to ``torch.topk`` after ``positive_nan`` (its plain
    version) and to its selection scheme in torch; overflow rows equal."""
    _overflow_count(run, reset_only=True)
    got = topk.topk_desc(x, k)
    n_kernel = _overflow_count(run)
    want = topk.topk_desc_plain(x, k)
    scheme, refined = topk.topk_radix_plain(x, k)
    sync(run.device)
    n_plain = int(refined.sum())
    passed = nan_equal(got, want) and nan_equal(scheme, want)
    passed &= n_kernel is None or n_kernel == n_plain
    run.record("topk", "B", passed, finite_err(got, want), **meta,
               overflow_rows=n_plain, overflow_rows_kernel=n_kernel)


def hold_cd(run: Run, x, k: int, meta: dict) -> None:
    """Kernels C and D: bitwise to the TPU kernel's tree order, the CUDA
    kernel's fold order and ``torch.topk`` after ``positive_nan``."""
    plains = {"reshape": ("C", topk.topk_desc_reshape_plain, topk.topk_desc_reshape_fold_plain),
              "natural": ("D", topk.topk_desc_natural_plain, topk.topk_desc_natural_fold_plain)}
    want = topk.topk_desc_plain(x, k)
    for variant, (letter, tree, fold) in plains.items():
        got = topk.topk_desc(x, k, variant=variant)
        wants = (tree(x, k), fold(x, k), want)
        sync(run.device)
        run.record("topk", letter, all(nan_equal(got, w) for w in wants),
                   finite_err(got, want), **meta)


def _sums_close(got, want, rtol: float, atol: float) -> bool:
    return bool(torch.isclose(got.double(), want.double(), rtol=rtol, atol=atol,
                              equal_nan=True).all())


def prepass_oracle(x: torch.Tensor, k: int):
    """The TPU script's formulas (validate_pallas_tpu.py:177-187) for the
    rows of ``x`` whose values are all finite, the sums in float64:
    ``(rows, log_ntl, log_sum_ll)``."""
    rows = torch.isfinite(x).all(dim=1)
    xr = x[rows]
    c = xr.amax(dim=1)
    xs = xr - c[:, None]
    vals = torch.topk(xs, k, dim=1).values
    floor = math.log(np.finfo(np.float64).tiny)
    xc = torch.clamp_min(vals[:, k - 1].double(), floor)
    xs64 = xs.double()
    mass = torch.where(xs64 <= xc[:, None], torch.exp(xs64 - xc[:, None]), 0.0).sum(dim=1)
    return rows, xc + torch.log(mass), torch.logsumexp(-xr.double(), dim=1)


def hold_a(run: Run, x, k: int, meta: dict, section: str = "prepass") -> None:
    """Kernel A: vals and C bitwise to its plain version, the sums within
    SUM_RTOL / SUM_ATOL of it and within ORACLE_TOL of the TPU script's
    float64 formulas on finite rows; overflow rows equal to the scheme's."""
    _overflow_count(run, reset_only=True)
    got = topk.loo_prepass(x, k)
    n_kernel = _overflow_count(run)
    want = topk.loo_prepass_plain(x, k)
    rows, ntl64, lppd64 = prepass_oracle(x, k)
    sync(run.device)
    n_plain = _plain_overflow(x, k, skip_nan_rows=True)
    passed = nan_equal(got[0], want[0]) and nan_equal(got[1], want[1])
    passed &= all(_sums_close(g, w, SUM_RTOL, SUM_ATOL) for g, w in zip(got[2:], want[2:]))
    passed &= _sums_close(got[2][rows], ntl64, EPS32, ORACLE_TOL)
    passed &= _sums_close(got[3][rows], lppd64, EPS32, ORACLE_TOL)
    passed &= n_kernel is None or n_kernel == n_plain
    diff = max([finite_err(got[0], want[0])]
               + [finite_err(g, w) for g, w in zip(got[2:], want[2:])])
    run.record(section, "A", passed, diff, **meta, overflow_rows=n_plain,
               overflow_rows_kernel=n_kernel,
               oracle_rows=int(rows.sum()),
               oracle_max_abs_diff=max(finite_err(got[2][rows], ntl64),
                                       finite_err(got[3][rows], lppd64)))


def section_kernels(run: Run, section: str, cases=None) -> None:
    """``topk`` (B, C, D) or ``prepass`` (A) over ``cases`` (default
    :func:`grid_cases`)."""
    if cases is None:
        cases = grid_cases(topk.MAX_K)
    for s, k, b, col, family in cases:
        x = as_view(family_rows(family, b, s, k, run.gen, run.device), col)
        meta = {"s": s, "k": k, "b": b, "col": col, "ld": x.stride(0) if b > 1 else s,
                "family": family}
        if section == "prepass":
            hold_a(run, x, k, meta)
        else:
            hold_b(run, x, k, meta)
            if k <= topk.BITONIC_MAX_K:
                hold_cd(run, x, k, meta)
        del x
    if section == "prepass":
        # the PSIS tail past one pass's k: no kernel takes it, the plain route does
        for s, reff in REFF_TAILS:
            k = tail_length(s, reff) + 1
            if not topk.supports(s, k):
                route = fast_path_route(s, k, torch.float32, run.device)
                run.record(section, "route", route == "torch", 0.0, s=s, k=k, reff=reff,
                           route=route)


def _multi_close(got, want, tol) -> tuple:
    """Rows of got within ``tol`` (per row) of want, NaN matching NaN and an
    infinity matching itself; and the largest finite difference."""
    g, w = got.double(), want.double()
    same = (g == w) | (g.isnan() & w.isnan())
    near = (g - w).abs() <= tol.reshape(-1, *([1] * (g.dim() - 1)))
    return bool((same | near).all()), finite_err(g, w)


def section_multi(run: Run, shapes=None, narrow=None) -> None:
    """Kernel A over draw-axis parts and kernel B's merge
    (``loo_prepass_multi``) against one pass of the plain version over the
    whole row, and each part bitwise to the plain version."""
    tiny32 = math.log(float(np.finfo(np.float32).tiny))
    shapes = MULTI_SHAPES if shapes is None else shapes
    narrow = NARROW_PARTS if narrow is None else narrow
    cases = [(s, k, topk.multipass_parts(s, k), b, family) for s, k, b, family in shapes]
    cases += [(s, k, parts, (3, 16, 1, 5, 64)[i % 5], FAMILIES[i % len(FAMILIES)])
              for i, (s, k, parts) in enumerate(narrow)]
    for s, k, parts, b, family in cases:
        meta = {"s": s, "k": k, "b": b, "parts": parts, "family": family}
        if parts is None or parts < 2:
            run.record("multi", "A multipass", False, math.inf, **meta,
                       why="multipass_parts gives no split")
            continue
        x = family_rows(family, b, s, k, run.gen, run.device)
        part_s = -(-s // parts)
        for p in range(parts):  # each part: kernel A on a view at its column
            view = x[:, p * part_s : (p + 1) * part_s]
            got, want = topk.loo_prepass(view, k), topk.loo_prepass_plain(view, k)
            sync(run.device)
            if not (nan_equal(got[0], want[0]) and nan_equal(got[1], want[1])):
                run.record("multi", "A part", False, finite_err(got[0], want[0]), **meta,
                           part=p, col=p * part_s)
        got = topk.loo_prepass_multi(x, k, parts)
        want = topk.loo_prepass_plain(x, k)
        sync(run.device)
        finite = torch.where(torch.isfinite(x), x.abs(), 0.0).amax(dim=1).double()
        rebase = MULTI_ULPS * EPS32 * torch.clamp_min(finite, 1.0)
        vals_ok, vals_diff = _multi_close(got[0], want[0], rebase)
        # the merge sums the non-tail mass in the log domain: where one
        # pass's float32 sum underflows to 0 (log -inf) the merge keeps the
        # log of a mass below float32's least normal (ROADMAP Queue 3 item 5)
        deep = torch.isneginf(want[2]) & (got[2] < tiny32)
        ntl = torch.where(deep, want[2], got[2])
        sums_ok, sums_diff = True, 0.0
        for g, w in ((ntl, want[2]), (got[3], want[3])):
            tol = SUM_ATOL + SUM_RTOL * w.double().abs().nan_to_num(posinf=0.0, neginf=0.0)
            ok, diff = _multi_close(g, w, tol + rebase)
            sums_ok &= ok
            sums_diff = max(sums_diff, diff)
        passed = vals_ok and sums_ok and nan_equal(got[1], want[1])
        run.record("multi", "A multipass + B merge", passed, max(vals_diff, sums_diff), **meta,
                   deep_rows=int(deep.sum()))
        del x


# --------------------------------------------------------------------------
# the float64 programs
# --------------------------------------------------------------------------


def section_exact(run: Run, shapes=((64, 1_000), (32, 4_000), (16, 8_000))) -> None:
    """Float64 ``psislw`` on the device against the NumPy oracle, on normal
    rows and (the first quarter) t(2) rows."""
    from .. import psislw
    from .oracle import psis_matrix

    for b, s in shapes:
        lw_np = run.rng.normal(0.0, 1.0, size=(b, s))
        lw_np[: b // 4] = run.rng.standard_t(2, size=(b // 4, s)) * 2.0
        lw_got, k_got = psislw(torch.as_tensor(lw_np, device=run.device))
        lw_want, k_want = psis_matrix(lw_np)
        lw_err = float(np.max(np.abs(lw_got - lw_want)))
        fin = np.isfinite(k_want)
        k_err = float(np.max(np.abs(k_got[fin] - k_want[fin]), initial=0.0))
        inf_match = bool(np.array_equal(np.isfinite(k_got), fin))
        run.record("exact", "psislw float64", lw_err < EXACT_TOL and k_err < EXACT_TOL
                   and inf_match, max(lw_err, k_err), s=s, b=b, lw_max_abs_diff=lw_err,
                   k_max_abs_diff=k_err, inf_mask_equal=inf_match, oracle="numpy f64")


def section_eloo(run: Run, shapes=((128, 1_000), (32, 4_000))) -> None:
    """The weighted mean, variance and quantile against float64 NumPy;
    ``khat_batch`` against the same function on the CPU."""
    from ..ops.expectations import (khat_batch, weighted_mean_batch,
                                    weighted_quantile_batch, weighted_variance_batch)

    probs = np.array([0.1, 0.5, 0.9])
    for b, s in shapes:
        x = run.rng.normal(size=(b, s))
        lw = run.rng.standard_t(3, size=(b, s)) * 0.7
        xd = torch.as_tensor(x, device=run.device)
        lwd = torch.as_tensor(lw, device=run.device)
        got = {
            "weighted_mean": weighted_mean_batch(xd, lwd),
            "weighted_variance": weighted_variance_batch(xd, lwd),
            "weighted_quantile": weighted_quantile_batch(
                xd, lwd, torch.as_tensor(probs, device=run.device)),
            "khat": khat_batch(xd, lwd, tail_len=20),
        }
        got = {name: v.cpu().numpy() for name, v in got.items()}

        mx = lw.max(axis=1, keepdims=True)
        w = np.exp(lw - mx)
        w /= w.sum(axis=1, keepdims=True)
        m_want = (w * x).sum(axis=1)
        msq = (w * x**2).sum(axis=1)
        wss = (w**2).sum(axis=1)
        v_want = np.maximum((msq - m_want**2) / (1.0 - wss), 0.0)
        # rows where one weight dominates (sum w^2 ~ 1) give 0
        v_want = np.where(np.isclose(wss, 1.0), 0.0, v_want)
        order = np.argsort(x, axis=1)
        xs = np.take_along_axis(x, order, axis=1)
        cw = np.cumsum(np.take_along_axis(w, order, axis=1), axis=1)
        cw /= cw[:, -1:]
        q_want = np.empty((b, len(probs)))
        rows = np.arange(b)
        for j, p in enumerate(probs):
            wi = np.argmax(cw >= p, axis=1)
            lo = np.maximum(wi - 1, 0)
            x_hi, x_lo = xs[rows, wi], xs[rows, lo]
            w_hi, w_lo = cw[rows, wi], cw[rows, lo]
            denom = np.where(w_hi == w_lo, 1.0, w_hi - w_lo)
            q_want[:, j] = np.where(wi == 0, xs[:, 0], x_lo + (x_hi - x_lo) * (p - w_lo) / denom)
        k_want = khat_batch(torch.as_tensor(x), torch.as_tensor(lw), tail_len=20).numpy()
        wants = {"weighted_mean": m_want, "weighted_variance": v_want,
                 "weighted_quantile": q_want, "khat": k_want}
        for name, want in wants.items():
            err = float(np.max(np.abs(got[name] - want)))
            run.record("eloo", name, err < ELOO_TOL, err, s=s, b=b,
                       oracle="the same function on the CPU" if name == "khat" else "numpy f64")


def section_nonfactor(run: Run, shapes=((12, 5), (48, 4))) -> None:
    """MVN and MVT conditional log-likelihoods against the partitioned
    normal and the direct Student-t formula, one draw and observation at a
    time in NumPy float64."""
    from scipy import stats
    from scipy.special import gammaln

    from ..ops.nonfactor import mvn_conditional_loglik, mvt_conditional_loglik

    rng = run.rng
    for n_obs, n_draws in shapes:
        a = rng.normal(size=(n_obs, n_obs)) * 0.3
        base_cov = a @ a.T + np.eye(n_obs)
        mu = rng.normal(size=n_obs)
        y = rng.multivariate_normal(mu, base_cov)
        mus = mu[None, :] + rng.normal(0, 0.05, size=(n_draws, n_obs))
        covs = np.empty((n_draws, n_obs, n_obs))
        for d in range(n_draws):
            j = rng.normal(0, 0.01, size=(n_obs, n_obs))
            covs[d] = base_cov + (j + j.T) / 2 + 0.01 * np.eye(n_obs)
        df = 5.0 + 5.0 * np.arange(n_draws)
        mvn_got = mvn_conditional_loglik(y, mus, cov=covs).cpu().numpy()
        mvt_got = mvt_conditional_loglik(y, mus, df, cov=covs).cpu().numpy()

        mvn_want = np.empty((n_draws, n_obs))
        mvt_want = np.empty((n_draws, n_obs))
        for d in range(n_draws):
            prec = np.linalg.inv(covs[d])
            r = y - mus[d]
            g = prec @ r
            cbar = np.diag(prec)
            for i in range(n_obs):
                keep = np.delete(np.arange(n_obs), i)
                c22i = np.linalg.inv(covs[d][np.ix_(keep, keep)])
                c12 = covs[d][np.ix_([i], keep)]
                cm = mus[d][i] + (c12 @ c22i @ (y[keep] - mus[d][keep]))[0]
                cv = covs[d][i, i] - (c12 @ c22i @ c12.T)[0, 0]
                mvn_want[d, i] = stats.norm.logpdf(y[i], cm, np.sqrt(cv))
                pmm = prec[np.ix_(keep, keep)]
                pcol = prec[keep, i]
                eff = pmm - np.outer(pcol, pcol) / prec[i, i]
                beta = r[keep] @ eff @ r[keep]
                cond_df = df[d] + n_obs - 1
                cond_loc = y[i] - g[i] / cbar[i]
                cond_scale = (df[d] + beta) / cond_df / cbar[i]
                mvt_want[d, i] = (
                    gammaln((cond_df + 1) / 2) - gammaln(cond_df / 2)
                    - 0.5 * np.log(cond_df * np.pi * cond_scale)
                    - ((cond_df + 1) / 2) * np.log(1 + (y[i] - cond_loc) ** 2
                                                   / (cond_scale * cond_df))
                )
        for name, got, want in (("mvn_conditional", mvn_got, mvn_want),
                                ("mvt_conditional", mvt_got, mvt_want)):
            err = float(np.max(np.abs(got - want)))
            run.record("nonfactor", name, err < NONFACTOR_TOL, err, n_obs=n_obs,
                       n_draws=n_draws, oracle="partitioned brute force")


# The outlier model's fit: the draws moment matching then improves.  4
# leapfrog steps, against the sampler's default of 32, keep it short: the
# step loop is launch bound on the card (8 steps took 37 s of the section
# on an H100), and a 2-parameter posterior needs no longer trajectory
MM_FIT = dict(draws=500, tune=500, chains=2, seed=7, num_leapfrog=4)


def section_mm(run: Run, fit_kwargs=None) -> None:
    """The device-batched moment-matching program against the host greedy
    loop on the TPU script's outlier model (30 observations, one gross
    outlier), split and not: loo_i and pareto_k within MM_TOL, the largest k
    lower than before."""
    from .. import JAXModelWrapper, loo, loo_moment_match
    from ..models.wrapper import Model, fit

    y = run.rng.normal(1.0, 1.0, size=30)
    y[0] = 8.5  # one gross outlier -> high pareto_k -> moment matching
    half_log_2pi = 0.5 * math.log(2 * math.pi)

    def logp(p, d):
        r = (d["y"] - p["mu"]) / torch.exp(p["log_s"])
        return (-0.5 * (p["mu"] / 10) ** 2 - 0.5 * (p["log_s"] / 2) ** 2
                + torch.sum(-half_log_2pi - p["log_s"] - 0.5 * r**2))

    def log_lik(p, d):
        r = (d["y"] - p["mu"]) / torch.exp(p["log_s"])
        return -half_log_2pi - p["log_s"] - 0.5 * r**2

    model = Model("ls", {"y": y}, {"mu": (), "log_s": ()}, logp, log_lik, obs_keys=("y",))
    kwargs = dict(MM_FIT, **(fit_kwargs or {}))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        idata = fit(model, **kwargs)
        wrapper = JAXModelWrapper(model, idata)
        orig = loo(idata, pointwise=True, reff=1.0)
        for split in (False, True):
            host = loo_moment_match(wrapper, orig, split=split, cov=True, device_batched=False)
            dev = loo_moment_match(wrapper, orig, split=split, cov=True, device_batched=True)
            loo_err = float(np.max(np.abs(dev.loo_i.values - host.loo_i.values)))
            k_err = float(np.max(np.abs(dev.pareto_k.values - host.pareto_k.values)))
            improved = float(np.max(dev.pareto_k.values)) < float(np.max(orig.pareto_k.values))
            run.record("mm", "moment_match_device", loo_err < MM_TOL and k_err < MM_TOL
                       and improved, max(loo_err, k_err), split=split, n_obs=30,
                       n_draws=kwargs["draws"] * kwargs["chains"], max_k_improved=improved,
                       oracle="host greedy loop")


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------


def run_sections(run: Run, sections) -> bool:
    """Each of ``sections`` in turn, with its summary line, with
    ``rcParams["device.device"]`` the run's device (each section's
    entry points run there); True if every case passed."""
    ok = True
    for section in sections:
        t0 = time.perf_counter()
        with on_device(run.device):
            if section in ("topk", "prepass"):
                section_kernels(run, section)
            else:
                globals()[f"section_{section}"](run)
        if run.on_card:
            torch.cuda.empty_cache()
        ok &= run.summary(section, t0)
    return ok


def write_records(run: Run, path: str, ok: bool) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    out = {"platform": run.platform, "device": str(run.device), "card": run.card,
           "all_pass": ok, "n_cases": len(run.records), "cases": run.records}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m pyloo_tpu_torch.tools.validate_kernels",
        description="Hold the port's kernels and float64 programs to their plain versions"
                    " and oracles, on the card.")
    parser.add_argument("sections", nargs="*", metavar="section",
                        help=f"any of {', '.join(SECTIONS)} (default: all)")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--out", default=os.path.join("build", "validate_kernels.json"))
    args = parser.parse_args(argv)
    unknown = sorted(set(args.sections) - set(SECTIONS))
    if unknown:
        parser.error(f"unknown sections: {unknown}")
    sections = [s for s in SECTIONS if s in args.sections] or list(SECTIONS)
    device = resolve_device(args.device, "validate_kernels")
    run = Run(device, SEED)
    ok = run_sections(run, sections)
    write_records(run, args.out, ok)
    print(f"{'PASS' if ok else 'FAIL'}: {len(run.records)} cases on {run.platform}"
          f" ({run.card or 'no card'}) -> {args.out}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
