"""Drive pyloo_tpu_torch's main paths once on one NVIDIA GPU and check them.

Usage, from the root of the repository, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases:

0. the card (``nvidia-smi`` name and power limit) and the kernel build (one
   ``nvcc`` per source, started together), with each kernel's registers and
   spill bytes as ``ptxas`` reports them;
1. kernels A and B against their plain PyTorch versions at the shapes the
   main paths give them (131,072 x 4,000; 16,384 x 16,000; 4,096 x 32,768;
   one part and the merge of phase 2b's 80,000 draws) and on concentrated
   rows (x = 0.7 + 0.01 z at 131,072 x 4,000), with their times, blocks per
   SM and the rows whose first radix digit overflowed the kernels' candidate
   buffer, counted against the plain version of the kernels' selection scheme;
1b. kernels C and D (``topk_desc(variant="reshape"|"natural")``) against
   their plain versions (the TPU kernels' tree order and the CUDA kernels'
   fold order) and ``torch.topk``, bitwise, with their times at
   131,072 x 4,000, 16,384 x 16,000 and 4,096 x 32,768, on concentrated
   rows, and on ragged, short and unaligned rows; then the profiling
   harness (kernel E) over the three top-k variants at 125,000 x 4,000 ->
   191;
2. ``loo()`` in float32 at 1,000,000 observations x 4,000 draws (a logistic
   regression with 32 features, made on the card from a seed), through the
   fused prepass kernel, checked against the plain scorer on the card (which
   launches no kernel, counted); then
   ``loo()`` at 80,000 draws, through the multipass split and its top-k
   merge;
3. the default float64 path on the first 250,000 observations, held to the
   float32 results;
4. ``loo(centered_eight)`` against the published baseline;
5. ``loo_streaming`` in float32 at 1,000,000 x 4,000 with the model on the
   card (the log-likelihood made chunk by chunk), held to phase 2's ``loo()``;
5b. ``loo_streaming`` over the first 250,000 rows of the phase-2 matrix, held
   to ``loo()`` on the same rows in float32 and float64;
6. the importance-weights path through its public entry points, on the first
   262,144 rows of the phase-2 matrix in float32: ``psislw`` held to phase 2's
   ``loo()`` (k, and ``logsumexp(lw + ll)`` against ``loo_i``),
   ``psislw_compact`` held to ``psislw``, 4,096 rows and a block of tied rows
   in float64 against the same call on the CPU, ``waic`` at 1,000,000 x 4,000,
   ``loo_i``, ``e_loo``, ``mcse_loo``, ``psis_ess_values`` and ``loo_group``,
   each held to a number the run already has or to the CPU on a 4,096-row
   cut; the wall time, peak device memory and kernel launches of each call
   (each a launch window of its own; this path selects with indices, through
   ``torch.topk``), and ``topk_with_idx`` timed against a stable row sort;
7. scoring and model comparison, each call a launch window of its own:
   ``loo_compare_streaming`` with ``ic="loo"`` and ``ic="waic"`` on phase 5's
   model and a worse one (features 16-31 of every draw set to 0) at
   1,000,000 x 4,000, stacked by the EM solver on the card; ``loo_compare``
   on the stored first 250,000 rows of each model, and SLSQP, BB-pseudo-BMA
   and pseudo-BMA on a 50,000-row cut against the CPU; ``loo_score_streaming``
   (posterior-predictive draws Bernoulli(sigmoid(eta)) from a counter-based
   hash, two permutations, CRPS and SCRPS) held to ``loo_score`` on a stored
   65,536-row cut and, in float64 on 4,096 rows, to the CPU, with one chunk's
   time split into generators, ``psislw_batch`` and means; ``loo_lfo`` at
   10,000 time points x 4,000 float64 (M = 1 and 4), its first 1,024 targets
   held to the CPU on the series cut after them;
8. a log-likelihood on disk: the first 250,000 rows of phase 2's matrix
   written as float32 ``.npy`` to a temporary directory (removed at the
   end); ``loo_from_file`` with the native prefetcher at the default
   geometry, equal to phase 5b's ``loo_streaming`` over the same rows, then
   ``loo_streaming`` over an ``NpyLogLik`` in 8 chunks with the native and the
   memmap reader (``is_native``, ``reads_issued`` equal to the chunk count),
   one chunk's host read, pinned and pageable copy and scoring timed, and
   ``waic_from_file`` held to phase 6's ``waic`` on those rows; then
   ``e_loo_streaming`` (mean, variance, quantile),
   ``loo_predictive_metric_streaming`` (mae, acc) and ``loo_group_streaming``
   (1,000 groups) at 1,000,000 x 4,000 with phase 5's model and phase 7's
   predictive draws, each held to its stored-matrix form on the first
   262,144 rows, made by the same generator calls;
9. subsampled LOO and LOO for an approximate posterior:
   ``loo_subsample_streaming`` at 1,000,000 x 4,000 (4,000 rows, diff_srs and
   hh_pps; the sampled rows equal ``subsample_indices``' on the host, the
   estimate within 4 subsampling SEs of phase 5's), ``loo_subsample`` and
   ``update_subsample`` (4,000 -> 8,000) on 250,000 stored rows, and
   ``loo_approximate_posterior_streaming`` at 1,000,000 x 4,000 (log_p, log_q
   two normal densities of one coefficient's draws) held to
   ``loo_approximate_posterior`` on 250,000 stored rows;
10. model wrappers, moment matching and exact refits, in float64, the HMC
   step loop under ``torch.cuda.set_sync_debug_mode("error")`` (a read of a
   device value on the host raises): (a) ``fit(roaches_model())``, 4 chains
   x 500 + 500 draws, 32 leapfrog steps (wall, ms a step, acceptance,
   split-R-hat < 1.05), ``loo`` and ``loo(moment_match=True, split=True)``
   on the device-batched path and the host loop, held to each other within
   1e-10 in ``loo_i`` and ``pareto_k``; (b) the greedy loops of the two
   paths on an overdispersed Poisson regression (600 observations, P = 10,
   S = 4,000 draws of its Laplace approximation, >= 64 observations k >
   0.7): the batched path over all of them, with its passes and peak device
   memory against its budget, the host loop over 8, each timed per
   observation; (c) ``loo_kfold`` on ``wells_model()`` (3,020 observations,
   K = 10) as one batched HMC run of 40 chains, and ``reloo`` on the roaches
   fit batched over its k > 0.7 observations, each against the PSIS elpd;
11. the NUTS and ChEES samplers, the Laplace and ADVI fits and
   non-factorised LOO, in float64, each public call a launch window of its
   own: (a) ``fit(eight_schools_noncentered(), algorithm="nuts")``, 4 chains
   x 500 + 500 at max_depth 8, and (b) ``algorithm="chees"``, 16 chains x
   500 + 500, each step loop under sync debug mode "error" but for its
   counted host reads (one a doubling, one an iteration), with split-R-hat
   < 1.05 on mu and tau; (c) ``Laplace`` and ``ADVI`` (mean-field and
   full-rank, 2,000 steps) of ``wells_model()``, 4 x 1,000 draws each, each
   through ``loo_approximate_posterior`` within 1.0 (Laplace) or 5.0 (ADVI,
   not converged at 2,000 steps) of the PSIS elpd_loo of phase 10c's
   Laplace draws; (d) ``loo_nonfactor`` on a joint MVN, N = 512,
   S = 4,000 (8.4 GB of float64 matrices, copied to the card a chunk at a
   time) in the ``cov``, ``student_t``, ``prec`` and diagonal forms, held to
   the CPU path on 64 draws (1e-10), ``cov`` to ``prec`` (1e-8) and the
   diagonal form to ``loo()`` of the pointwise normal log-likelihood, and
   ``loo_nonfactor_streaming`` on the same covariances, handed over a chunk
   at a time by its matrix function, held to the ``cov`` form bit for bit;
   and one chunk of 8 GP covariances made on the card at N = 2,048 and
   2,100, its merged inverse factor held to the triangular solve (1e-14
   relative), the Cholesky, the inverse and the solve timed;
12. first use, ingestion, profiling and the PyMC bridge: (a) two fresh
   processes (``first_use_child``), each importing the package and making
   phase 5's model, one running phase 5's ``loo_streaming`` twice, the
   other ``warmup(1,000,000, 4,000, dtype=torch.float32)`` and then the
   call once (the walls; A's launches in warmup's window; warmup's chunk
   against ``loo_streaming``'s; every result equal to phase 5's bit for
   bit); (b) the first 3,020 observations of phase 2's matrix (wells'
   size) as four CmdStan CSV files, read by ``from_cmdstan`` and
   ``to_inference_data`` (parse time, MB/s), ``loo()`` in float32 and
   float64 equal to ``loo()`` of the same matrix through ``from_dict`` bit
   for bit; (c) phase 5's ``loo_streaming`` under ``profiling.trace`` with
   ``annotate``, kernel A named in the trace as often as its counter reads;
   (d) eight schools (non-centred) as a bridge of torch functions through
   ``from_bridge`` and ``PyMCWrapper``, its log density and log-likelihood
   over 4 x 1,000 draws on the card against the CPU within 1e-12; a float64
   ``warmup`` loads no kernel library and launches nothing;
13. the multi-device layer over ``smoke_mesh()`` (every card with two or
   more, else four shards of ``cuda:0``): the cards' names and power
   limits; with two cards, kernels A and B launched on ``cuda:1`` leave
   ``cuda:0`` current; phase 5's ``loo_streaming`` with the model copied to
   each card, per row equal to the call with no mesh bit for bit, kernel A
   once a shard and chunk (counted a card), and its transfer census (no
   copy between cards larger than a scalar); ``loo()`` in float32 and
   float64 on phase 6's 262,144-row cut, per row equal to one device; each
   wall beside the wall with no mesh.  Phase 10a's batched moment matching
   (within 1e-10) and phase 11d's ``cov`` form (bit for bit) run once more
   over the same mesh;
14. edge rows: (a) kernels A-D against their plain versions on rows of NaN
   of either sign (one, many, k - 1, k, k + 1, a row), +inf and -inf
   entries and rows, a single finite value among -inf or +inf, subnormals,
   +-FLT_MAX and +-0.0 at the k-th place, first in batches of 131,072 x
   4,000 and 4,096 x 32,768, and on phase 2b's part, merge and multipass
   split at 80,000 draws: values and C equal with NaN matching NaN (NaN
   first, C NaN on a row with a NaN); (b) phase 5's ``loo_streaming`` with
   NaN, +inf and -inf draws planted in 384 rows, held to the port on the
   CPU over those rows and 3,712 clean ones, every other row equal to
   phase 5's bit for bit; (c) the same rows on phase 6's 262,144-row cut
   through ``loo_from_file``, ``loo_compare_streaming``, float32 ``loo()``,
   ``loo_group`` and ``loo_subsample``, each a launch window of its own;
15. the benchmark's two cells (``bench_torch/``), once each through its own
   functions: ``loo_streaming`` at 1,000,000 x 4,000 float32 with the model
   on the card, and float64 ``loo()`` on a host array of the model's first
   262,144 observations, each held by its gate to the plain float64
   reference (``bench_torch/reference.py``) on 512 seeded rows, each a
   launch window of its own, with its wall time;
16. the repo's two verification harnesses, ported
   (``pyloo_tpu_torch/tools/validate_kernels.py``, every section: kernels
   A-D bitwise to their plain versions over the card's envelope, S 2 to
   32,768 and beyond by draw-axis parts, k 1 to 1,024, B 1 to 4,099, views at
   unaligned columns, adversarial, tie, overflow, concentrated and edge
   rows; float64 PSIS, e_loo, non-factorised and moment-matching programs
   against their oracles; and ``fuzz_differential.py``, every mode with a
   fixed seed, each trial also held to the CPU), their launches counted
   outside the main-path windows.

Every main path runs with the kernels' launch counters set to 0 just before
it and read just after; comparisons with the plain versions run outside
those windows.  Prints one JSON line of kernel results and, last,
``{"ok": true, "device": ...}``.  Exits non-zero, printing no result, when
there is no CUDA device, when the package is missing, or when any check
fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

_FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("  ok    " if ok else "  FAIL  ") + what, flush=True)
    if not ok:
        _FAILURES.append(what)


def median_ms(fn, runs: int = 7) -> float:
    """Median time of ``fn()`` on the card, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def profiled(fn) -> dict:
    """``fn()`` under ``torch.profiler``: the operations the card ran
    (kernels, and copies or fills), their summed device time, and the
    host's kernel-launch calls to the CUDA runtime or driver."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    got = {"kernels": 0, "copies": 0, "device_us": 0.0, "launch_calls": 0}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            kind = "copies" if event.name.startswith(("Memcpy", "Memset")) else "kernels"
            got[kind] += 1
            got["device_us"] += event.time_range.elapsed_us()
        elif event.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            got["launch_calls"] += 1
    return got


# Published peaks of one H100 SXM at 700 W: HBM3 rate and float32 outside
# the tensor cores (NVIDIA's data sheet, SXM part, dense rates)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# kernel key -> the name of its launch counter
KERNEL_COUNTERS = {"loo_prepass": "A", "topk_desc": "B", "topk_reshape": "C",
                   "topk_natural": "D", "topk_profile": "E", "psis_tail_fit": "F"}
PATH_LAUNCHES = dict.fromkeys("ABCDEF", 0)  # summed over the main-path windows
# lane instructions a second outside the tensor cores (the float32 rate's
# fused multiply-adds counted once), and the instructions of one candidate
# term of the tail fit: an accurate expf (~10), log1pf or expm1f and logf
# (~25) and the term's adds, abs and max (~5)
F32_INSTR_PER_S = 33.5e12
FIT_TERM_INSTR = 40


def zero_counts() -> None:
    """Set every kernel launch counter to 0 (just before a main path)."""
    from pyloo_tpu_torch.ops import topk
    from pyloo_tpu_torch.ops.loo_kernels import psis_tail_fit
    from pyloo_tpu_torch.ops.topk_profile import profile_topk_desc

    topk.loo_prepass.launches = 0
    for variant in topk.topk_desc.launches:
        topk.topk_desc.launches[variant] = 0
    profile_topk_desc.launches = 0
    psis_tail_fit.launches = 0


def read_counts(main_path: bool = True) -> dict:
    """The launch counters (just after a main path), added to PATH_LAUNCHES
    when the window was a main path's."""
    from pyloo_tpu_torch.ops import topk
    from pyloo_tpu_torch.ops.loo_kernels import psis_tail_fit
    from pyloo_tpu_torch.ops.topk_profile import profile_topk_desc

    by_variant = topk.topk_desc.launches
    got = {"A": topk.loo_prepass.launches, "B": by_variant["roll"],
           "C": by_variant["reshape"], "D": by_variant["natural"],
           "E": profile_topk_desc.launches, "F": psis_tail_fit.launches}
    if main_path:
        for name, n in got.items():
            PATH_LAUNCHES[name] += n
    return got


def bound_ms(bytes_moved: float, ops: float):
    """(least time in ms, what bounds it): bytes over the HBM rate against
    operations over the float32 rate."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def topk_bound(b: int, s: int, k: int):
    """Top-k: read B x S floats once, write B x k; at least one compare an element."""
    return bound_ms(4.0 * (b * s + b * k), float(b * s))


def smoke_rows(b: int, s: int, gen):
    """x = -log_lik rows: normal, a full-row tie, some -inf, a heavy tail,
    values that all share their top 12 bits (kernels A and B's candidate
    buffer overflows), and +0.0 and -0.0 mixed with the k-th value among them."""
    import torch

    ll = torch.randn(b, s, device="cuda", generator=gen) * 0.8 - 1.0
    ll[0] = -0.25  # full-row tie: x = 0.25
    ll[1, ::7] = math.inf  # x = -inf entries, not the whole row
    z = torch.randn(4, s, device="cuda", generator=gen)
    t3 = z[0] / torch.sqrt(z[1:].square().sum(dim=0) / 3.0)  # Student-t, 3 dof
    ll[2] = 2.0 * t3 - 1.0  # heavy tail
    mantissa = torch.randint(0, 2**20, (s,), device="cuda", generator=gen)
    ll[3] = -(1.0 + mantissa.float() * 2.0**-23)  # x in [1, 1.125): one first digit
    signs = torch.rand(s, device="cuda", generator=gen) < 0.5
    ll[4] = torch.where(signs, 0.0, -0.0)
    ll[4, ::50] = torch.randn(ll[4, ::50].shape, device="cuda", generator=gen)
    return (-ll).contiguous()


def nan_equal(a, b) -> bool:
    """Equal value for value (-0.0 equals +0.0, as torch.equal has it), a
    NaN matching a NaN of either sign."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def finite_err(got, want) -> float:
    """The largest |got - want| where both are finite."""
    import torch

    both = torch.isfinite(got) & torch.isfinite(want)
    return float(torch.where(both, (got - want).abs(), 0.0).max())


def nan_rows(want) -> str:
    """How many rows of a top-k hold a NaN (first, where they are held to
    it), for a check's message."""
    n = int(want[:, 0].isnan().sum())
    return f"; {n} rows with a NaN, NaN first" if n else ""


def hold_prepass(kern: dict, x, k: int, what: str) -> None:
    """Kernel A against its plain version: vals and C equal (NaN matching
    NaN), the sums within rtol 2e-6, atol 1e-6 (NaN where they are NaN)."""
    import torch

    from pyloo_tpu_torch.ops import topk

    got = topk.loo_prepass(x, k)
    want = topk.loo_prepass_plain(x, k)
    torch.cuda.synchronize()
    same = nan_equal(got[0], want[0]) and nan_equal(got[1], want[1])
    err = max(finite_err(g, w) for g, w in zip(got[2:], want[2:]))
    close = all(torch.allclose(g, w, rtol=2e-6, atol=1e-6, equal_nan=True)
                for g, w in zip(got[2:], want[2:]))
    kern["max_abs_err"] = max(kern["max_abs_err"], err)
    n_nan = int(want[1].isnan().sum())
    check(same and close, f"kernel A {what} k={k}: vals, C bitwise; log_ntl, log_sum_ll"
          f" max |err| {err:.3g} (rtol 2e-6, atol 1e-6)"
          + (f"; C NaN on {n_nan} rows (on the card: {int(got[1].isnan().sum())})" if n_nan else ""))


def hold_topk(kern: dict, x, k: int, what: str) -> None:
    """Kernel B against its plain version, torch.topk (every NaN first, as
    a positive NaN), bitwise."""
    import torch

    from pyloo_tpu_torch.ops import topk

    got = topk.topk_desc(x, k)
    want = topk.topk_desc_plain(x, k)
    torch.cuda.synchronize()
    kern["max_abs_err"] = max(kern["max_abs_err"], finite_err(got, want))
    check(nan_equal(got, want), f"kernel B {what} k={k}: bitwise to torch.topk{nan_rows(want)}")


def time_kernel(kern: dict, name: str, fn, plain, x, k: int, bound, library,
                data: str = "smoke rows", blocks_per_sm=None, plain_runs: int = 7) -> dict:
    """Times of a kernel, its plain version (before and after) and the
    library call at one shape, with the kernel's blocks per SM
    (``blocks_per_sm()``; kernel A's or B's query when None); printed and
    added to ``kern["by_shape"]``."""
    from pyloo_tpu_torch.ops import topk

    rows, s = x.shape
    row = {"shape": [rows, s, k], "data": data,
           "plain_ms": median_ms(lambda: plain(x, k), plain_runs),
           "ms": median_ms(lambda: fn(x, k))}
    row["plain_ms_after"] = median_ms(lambda: plain(x, k), plain_runs)
    row["bound_ms"], row["bound_by"] = bound
    row["library_ms"] = median_ms(lambda: library(x, k)) if library else None
    row["blocks_per_sm"] = (blocks_per_sm() if blocks_per_sm
                            else topk.blocks_per_sm(s, k, fused=name == "loo_prepass"))
    kern["by_shape"].append(row)
    lib = f", torch.topk {row['library_ms']:.3f} ms" if library else ""
    print(f"  time  {name} ({rows}, {s}) k={k}, {data}: kernel {row['ms']:.3f} ms"
          f" ({100 * row['bound_ms'] / row['ms']:.0f}% of the {row['bound_ms']:.3f} ms bound),"
          f" plain {row['plain_ms']:.3f} / {row['plain_ms_after']:.3f} ms (before / after){lib};"
          f" {row['blocks_per_sm']} blocks per SM", flush=True)
    return row


def prepass_bound(rows: int, s: int, k: int):
    """A reads the row once and writes k values and three scalars; per
    element it shifts, compares, takes two exps and adds twice."""
    return bound_ms(4.0 * (rows * s + rows * k + 3 * rows), 6.0 * rows * s)


def hold_overflow(x, k: int, what: str) -> None:
    """Rows whose first digit overflows the candidate buffer: counted by
    kernels A and B on the first 2,048 rows, against the plain version of
    their scheme."""
    from pyloo_tpu_torch.ops import topk

    sub = x[:2_048]
    topk.overflow_rows(reset=True)
    topk.loo_prepass(sub, k)
    n_a = topk.overflow_rows(reset=True)
    topk.topk_desc(sub, k)
    n_b = topk.overflow_rows(reset=True)
    n_plain = int(topk.topk_radix_plain(sub, k)[1].sum())
    check(n_a == n_b == n_plain, f"{what} k={k}: overflow rows of the first 2,048: A {n_a},"
          f" B {n_b}, plain scheme {n_plain}")


def phase_kernels(kernels: dict, tail_length) -> None:
    import torch

    from pyloo_tpu_torch.ops import topk

    print("phase 1: kernels A and B against their plain versions", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    a, b = kernels["loo_prepass"], kernels["topk_desc"]
    a["by_shape"], b["by_shape"] = [], []
    topk_values = lambda x, k: torch.topk(x, k, dim=1).values  # noqa: E731
    for rows, s in [(131_072, 4_000), (16_384, 16_000), (4_096, 32_768)]:
        k = tail_length(s) + 1
        x = smoke_rows(rows, s, gen)
        topk.overflow_rows(reset=True)
        hold_prepass(a, x, k, f"({rows}, {s})")
        hold_topk(b, x, k, f"({rows}, {s})")
        print(f"  rows  ({rows}, {s}): {topk.overflow_rows(reset=True)} rows overflowed the"
              f" first digit (more than {topk.candidate_cap(k)} keys in and above the k-th"
              f" key's bin) in kernels A and B together", flush=True)
        hold_overflow(x, k, f"({rows}, {s})")
        row_a = time_kernel(a, "loo_prepass", topk.loo_prepass, topk.loo_prepass_plain, x, k,
                            prepass_bound(rows, s, k), None)
        row_b = time_kernel(b, "topk_desc", topk.topk_desc, topk.topk_desc_plain, x, k,
                            topk_bound(rows, s, k), topk_values)
        if s == 4_000:
            for kern, row in ((a, row_a), (b, row_b)):
                for key in ("ms", "plain_ms", "plain_ms_after", "bound_ms", "bound_by",
                            "library_ms"):
                    kern[key] = row[key]
        del x

    # concentrated rows, x = 0.7 + 0.01 z: a posterior's spread of one
    # observation's -log_lik, every row's draws within one first-digit bin
    rows, s = 131_072, 4_000
    k = tail_length(s) + 1
    x = 0.7 + 0.01 * torch.randn(rows, s, device="cuda", generator=gen)
    hold_prepass(a, x, k, f"concentrated ({rows}, {s})")
    hold_topk(b, x, k, f"concentrated ({rows}, {s})")
    topk.overflow_rows(reset=True)
    topk.loo_prepass(x, k)
    n = topk.overflow_rows(reset=True)
    print(f"  rows  concentrated ({rows}, {s}): kernel A narrowed {n} rows ({100 * n / rows:.1f}%)"
          f" by a further digit", flush=True)
    hold_overflow(x, k, f"concentrated ({rows}, {s})")
    time_kernel(a, "loo_prepass", topk.loo_prepass, topk.loo_prepass_plain, x, k,
                prepass_bound(rows, s, k), None, "concentrated rows")
    time_kernel(b, "topk_desc", topk.topk_desc, topk.topk_desc_plain, x, k,
                topk_bound(rows, s, k), topk_values, "concentrated rows")
    del x

    # phase 2b's shapes: kernel A on one part of an 80,000-draw row (a view
    # at an unaligned column offset), kernel B on the merge of the parts
    s = 80_000
    k = tail_length(s) + 1
    parts = topk.multipass_parts(s, k)
    part_s = -(-s // parts)
    x = smoke_rows(8_192, s, gen)[:, part_s : 2 * part_s]
    hold_prepass(a, x, k, f"part (8192, {part_s}) at column {part_s}")
    time_kernel(a, "loo_prepass", topk.loo_prepass, topk.loo_prepass_plain, x, k,
                prepass_bound(8_192, part_s, k), None)
    x = smoke_rows(8_192, parts * k, gen)
    hold_topk(b, x, k, f"merge (8192, {parts * k})")
    time_kernel(b, "topk_desc", topk.topk_desc, topk.topk_desc_plain, x, k,
                topk_bound(8_192, parts * k, k), topk_values)
    del x

    rows, s = 1_024, 100_000
    k = tail_length(s) + 1
    parts = topk.multipass_parts(s, k)
    x = smoke_rows(rows, s, gen)
    got = topk.loo_prepass_multi(x, k, parts)
    want = topk.loo_prepass_plain(x, k)  # one pass over the whole row
    torch.cuda.synchronize()
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    ok = (
        torch.allclose(got[0], want[0], rtol=2e-6, atol=2e-5)  # parts rebase: one rounding
        and torch.equal(got[1], want[1])
        and all(torch.allclose(g, w, rtol=2e-6, atol=1e-6) for g, w in zip(got[2:], want[2:]))
    )
    a["max_abs_err"] = max(a["max_abs_err"], *errs[2:])
    check(ok, f"kernel A multipass ({rows}, {s}) k={k}, {parts} parts + kernel B merge:"
          f" max |err| vals {errs[0]:.3g}, C {errs[1]:.3g}, log_ntl {errs[2]:.3g},"
          f" log_sum_ll {errs[3]:.3g}")


def fit_bound(rows: int, m: int):
    """Kernel F reads M + 1 values and two scalars a row and writes three;
    each of the 30 + isqrt(M) candidates, and the posterior mean, takes one
    term a tail value (:data:`FIT_TERM_INSTR` instructions)."""
    t_bytes = (4.0 * rows * (m + 3) + 9.0 * rows) / HBM_BYTES_PER_S
    t_instr = rows * (31 + math.isqrt(m)) * m * FIT_TERM_INSTR / F32_INSTR_PER_S
    return 1e3 * max(t_bytes, t_instr), "bytes" if t_bytes >= t_instr else "instructions"


def phase_fit(kern: dict, tail_length) -> None:
    """Phase 1c: kernel F against its plain version on kernel A's compact
    tails of the main path's shape, and its time there (the envelope is
    phase 16's ``fit`` section)."""
    import torch

    from pyloo_tpu_torch.ops import loo_kernels, topk
    from pyloo_tpu_torch.tools import validate_kernels

    rows, s = 125_000, 4_000
    m = tail_length(s)
    print(f"phase 1c: kernel F against its plain version at ({rows}, {m + 1})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = 1.0 + 0.8 * torch.randn(rows, s, device="cuda", generator=gen)  # x = -log_lik
    vals, c, log_ntl, _ = topk.loo_prepass(x, m + 1)
    del x
    run = validate_kernels.Run(torch.device("cuda", torch.cuda.current_device()), 3)
    validate_kernels.hold_f(run, vals, log_ntl, c, s, {"s": s, "m": m, "b": rows})
    rec = run.records[-1]
    kern["max_abs_err"] = max(kern["max_abs_err"], rec["max_abs_diff"])
    check(rec["pass"], f"kernel F ({rows}, {m + 1}) against its plain version: max |diff|"
          f" {rec['max_abs_diff']:.3g}, {rec['degenerate_rows']} degenerate rows, flags equal")
    zero_counts()
    kern["ms"] = median_ms(lambda: loo_kernels.psis_tail_fit(vals, log_ntl, c, s))
    kern["plain_ms"] = median_ms(lambda: loo_kernels.psis_tail_fit_plain(vals, log_ntl, c, s), 3)
    launched = read_counts(main_path=False)["F"]
    kern["bound_ms"], kern["bound_by"] = fit_bound(rows, m)
    print(f"  time  psis_tail_fit ({rows}, {m + 1}): kernel {kern['ms']:.3f} ms"
          f" ({100 * kern['bound_ms'] / kern['ms']:.0f}% of the {kern['bound_ms']:.3f} ms bound,"
          f" {kern['bound_by']}), plain {kern['plain_ms']:.3f} ms; {launched} launches of F for"
          " 8 kernel runs", flush=True)
    del vals, c, log_ntl


def hold_variant(kern: dict, letter: str, variant: str, plains, x, k: int, what: str) -> None:
    """Kernel C or D against its plain versions (the tree order of the TPU
    kernel, the fold order of the CUDA kernel) and torch.topk (as kernel
    B's plain version has it), bitwise."""
    import torch

    from pyloo_tpu_torch.ops import topk

    got = topk.topk_desc(x, k, variant=variant)
    wants = [plain(x, k) for plain in plains] + [topk.topk_desc_plain(x, k)]
    torch.cuda.synchronize()
    kern["max_abs_err"] = max(kern["max_abs_err"], finite_err(got, wants[0]))
    check(all(nan_equal(got, want) for want in wants),
          f"kernel {letter} {what} k={k}: bitwise to its plain versions (tree order, fold"
          f" order) and to torch.topk{nan_rows(wants[-1])}")


def bitonic_variants() -> dict:
    """Kernel key -> (letter, variant, plain in the TPU kernel's tree order,
    plain in the CUDA kernel's fold order), for kernels C and D."""
    from pyloo_tpu_torch.ops import topk

    return {
        "topk_reshape": ("C", "reshape", topk.topk_desc_reshape_plain,
                         topk.topk_desc_reshape_fold_plain),
        "topk_natural": ("D", "natural", topk.topk_desc_natural_plain,
                         topk.topk_desc_natural_fold_plain),
    }


def phase_variants(kernels: dict) -> None:
    import torch

    from pyloo_tpu_torch.ops import topk
    from pyloo_tpu_torch.ops.topk_profile import profile_topk_desc

    print("phase 1b: kernels C and D against their plain versions and torch.topk", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    variants = bitonic_variants()
    topk_values = lambda x, k: torch.topk(x, k, dim=1).values  # noqa: E731

    def hold_and_time(x, k, what, data="smoke rows", plain_runs=7):
        rows, s = x.shape
        for name, (letter, variant, plain, fold) in variants.items():
            kern = kernels[name]
            hold_variant(kern, letter, variant, (plain, fold), x, k, what)
            row = time_kernel(
                kern, name, lambda x, k: topk.topk_desc(x, k, variant=variant), plain, x, k,
                topk_bound(rows, s, k), topk_values, data,
                blocks_per_sm=lambda: topk.bitonic_blocks_per_sm(variant), plain_runs=plain_runs)
            if (s, data) == (4_000, "smoke rows"):
                for key in ("ms", "plain_ms", "plain_ms_after", "bound_ms", "bound_by",
                            "library_ms"):
                    kern[key] = row[key]

    for name in variants:
        kernels[name]["by_shape"] = []
    for rows, s, k in [(131_072, 4_000, 191), (16_384, 16_000, 256), (4_096, 32_768, 256)]:
        x = smoke_rows(rows, s, gen)
        if s == 4_000:
            # row 4 mixes +0.0 and -0.0 around the k-th value: one of each must
            # survive every compare-exchange, so the bit patterns are the
            # order-preserving keys' top k
            head = x[:64]
            keys = topk._key_value(torch.topk(topk._order_key(head), k, dim=1).values)
            for letter, variant, _, _ in variants.values():
                got = topk.topk_desc(head, k, variant=variant)
                check(torch.equal(got.view(torch.int32), keys.view(torch.int32)),
                      f"kernel {letter} ({rows}, {s}) k={k}: the first 64 rows bit for bit,"
                      f" +0.0 above -0.0")
        hold_and_time(x, k, f"({rows}, {s})", plain_runs=7 if s == 4_000 else 3)
        del x

    # concentrated rows: the network does not look at the data
    rows, s, k = 131_072, 4_000, 191
    x = 0.7 + 0.01 * torch.randn(rows, s, device="cuda", generator=gen)
    hold_and_time(x, k, f"concentrated ({rows}, {s})", data="concentrated rows")
    del x

    # rows that are ragged, shorter than a segment, one value past a power of
    # two of segments, unaligned (4-byte loads), and the smallest and largest k
    wide = smoke_rows(4_096, 4_101, gen)
    odd = [
        (wide[:, 3:4_003], 191, "a view at column 3 of rows 4,101 apart (4096, 4000)"),
        (wide[:, :4_000], 1, "(4096, 4000) of rows 4,101 apart"),
        (smoke_rows(4_096, 4_000, gen), 256, "(4096, 4000)"),
        (smoke_rows(4_096, 300, gen), 256, "(4096, 300)"),
        (smoke_rows(4_096, 255, gen), 255, "(4096, 255)"),
        (smoke_rows(4_096, 255, gen), 1, "(4096, 255)"),
        (smoke_rows(2_048, 16_385, gen), 256, "(2048, 16385)"),
    ]
    for x, k, what in odd:
        for name, (letter, variant, plain, fold) in variants.items():
            hold_variant(kernels[name], letter, variant, (plain, fold), x, k, what)
    del wide, odd, x

    # kernel E: the profiling harness over each variant, its own main path
    b, s, k = 125_000, 4_000, 191
    print(f"phase 1b: profiling harness (kernel E) at ({b}, {s}) -> {k}", flush=True)
    e = kernels["topk_profile"]
    zero_counts()
    splits = {variant: profile_topk_desc(b, s, k, variant=variant)
              for variant in ("roll", "reshape", "natural")}
    got = read_counts()
    check(got["E"] > 0 and got["B"] > 0 and got["C"] > 0 and got["D"] > 0 and got["A"] == 0,
          f"harness launches: E {got['E']} (kernel alone), B {got['B']}, C {got['C']},"
          f" D {got['D']} (full topk_desc calls)")
    for variant, split in splits.items():
        check(split["max_abs_err"] == 0.0, f"harness {variant}: kernel-only output bitwise to"
              f" torch.topk (max |err| {split['max_abs_err']:.3g})")
        print(f"  time  {variant}: prep {split['prep_ms']:.4f} ms, kernel"
              f" {split['kernel_ms']:.3f} ms, full call {split['full_ms']:.3f} ms", flush=True)
    x = 1.5 * torch.randn(b, s, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    e["library_ms"] = median_ms(lambda: torch.topk(x, k, dim=1).values)
    e["plain_ms"] = median_ms(lambda: topk.topk_desc_plain(x, k))
    del x
    e["ms"] = splits["roll"]["kernel_ms"]
    e["max_abs_err"] = max(split["max_abs_err"] for split in splits.values())
    e["bound_ms"], e["bound_by"] = topk_bound(b, s, k)
    e["splits"] = splits
    print(f"  time  torch.topk ({b}, {s}) k={k}: {e['library_ms']:.3f} ms", flush=True)


def logistic_log_lik(n_obs: int, chains: int, draws: int, seed: int):
    """Host (chain, draw, obs) float32 log-likelihood of a logistic regression
    with 32 features, computed on the card; ``beta`` as its posterior; and
    the model on the card, ``(xw, yw, beta)``."""
    import numpy as np
    import torch

    from bench_torch import model as bench_model

    xw, yw, beta = bench_model.logistic_model(n_obs, chains, draws, seed, "cuda")
    zero = xw.new_zeros(())
    ll = np.empty((chains, draws, n_obs), np.float32)
    for c in range(chains):
        eta = beta[c] @ xw.T  # (draws, obs), full float32 (no TF32)
        torch.from_numpy(ll[c]).copy_(yw * eta - torch.logaddexp(eta, zero))
        del eta
    return ll, beta.cpu().numpy(), (xw, yw, beta)


def obs_major(ll_host, n_rows: int, start: int = 0):
    """The (n_rows, S) matrix loo() builds, for observations start...start + n_rows."""
    import numpy as np
    import torch

    chains, draws, _ = ll_host.shape
    part = torch.from_numpy(np.ascontiguousarray(ll_host[:, :, start : start + n_rows])).cuda()
    return part.reshape(chains * draws, -1).T.contiguous()


def run_loo(pl, idata, timed: dict):
    """``pl.loo`` with its ingest (from the call to the scorer's start: the
    sample matrix laid out and copied to the card) and its scoring part
    (apply_rowwise) timed on the side."""
    import torch

    loo_mod = sys.modules["pyloo_tpu_torch.loo"]  # the package's `loo` is the function
    real = loo_mod.apply_rowwise

    def timed_apply(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        timed["ingest_s"] = t - timed["start"]
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        timed["scoring_s"] = time.perf_counter() - t
        return out

    loo_mod.apply_rowwise = timed_apply
    try:
        torch.cuda.reset_peak_memory_stats()
        timed["start"] = time.perf_counter()
        res = pl.loo(idata, pointwise=True)
        torch.cuda.synchronize()
        timed["wall_s"] = time.perf_counter() - timed["start"]
        timed["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        loo_mod.apply_rowwise = real
    return res


def phase_main_path(pl, kernels: dict):
    import numpy as np

    from pyloo_tpu_torch._common import compute_reff
    from pyloo_tpu_torch.ops import topk
    from pyloo_tpu_torch.ops.loo_kernels import loo_scores_psis_fast
    from pyloo_tpu_torch.ops.psis import tail_length
    from pyloo_tpu_torch.parallel.sharding import chunk_rows

    print("phase 2: loo() float32 at 1,000,000 x 4,000", flush=True)
    n_obs, chains, draws = 1_000_000, 4, 1_000
    t = time.perf_counter()
    ll_host, beta, model = logistic_log_lik(n_obs, chains, draws, seed=7)
    print(f"  data  {ll_host.nbytes / 1e9:.1f} GB log-likelihood made in"
          f" {time.perf_counter() - t:.1f} s", flush=True)
    idata = pl.from_dict(posterior={"beta": beta}, log_likelihood={"y": ll_host})
    m_tail = tail_length(chains * draws, compute_reff(idata, None, chains * draws))
    pl.rcParams["device.device"] = "cuda"
    pl.rcParams["device.precision"] = "float32"

    # the main path's run: every launch counter from 0, read right after
    topk.overflow_rows(reset=True)
    zero_counts()
    timed: dict = {}
    res = run_loo(pl, idata, timed)
    got = read_counts()
    n_over = topk.overflow_rows(reset=True)
    n_chunks = -(-n_obs // chunk_rows(chains * draws, 4))
    check(got["A"] == got["F"] == n_chunks and got["B"] == got["C"] == got["D"] == got["E"] == 0,
          f"kernels A and F launched {got['A']} and {got['F']} times for {n_chunks} chunks;"
          f" kernel B {got['B']}")
    loo_i, khat = res.loo_i.values, res.pareto_k.values
    check(loo_i.shape == (n_obs,) and np.isfinite(loo_i).all() and np.isfinite(khat).all(),
          f"loo_i, pareto_k finite, shape {loo_i.shape}; elpd_loo {res['elpd_loo']:.6f},"
          f" {res.fast_path_degenerate} degenerate rows")
    print(f"  time  loo() {timed['wall_s']:.3f} s wall, ingest {timed['ingest_s']:.3f} s, scoring"
          f" {timed['scoring_s']:.3f} s, {n_obs / timed['wall_s']:.0f} obs/s; peak device memory"
          f" {timed['peak_gb']:.2f} GB", flush=True)
    print(f"  rows  kernel A narrowed {n_over} of {n_obs} rows ({100 * n_over / n_obs:.2f}%) by a"
          f" further digit", flush=True)

    # beyond one block's 32,768 draws: kernel A per part, kernel B in the merge
    print("phase 2b: loo() float32 at 8,192 x 80,000 (multipass)", flush=True)
    ll_wide, beta_wide, _ = logistic_log_lik(8_192, 4, 20_000, seed=8)
    wide = pl.from_dict(posterior={"beta": beta_wide}, log_likelihood={"y": ll_wide})
    m_wide = tail_length(80_000, compute_reff(wide, None, 80_000))
    timed_wide: dict = {}
    zero_counts()
    res_wide = run_loo(pl, wide, timed_wide)
    got = read_counts()
    wide_a, wide_b = got["A"], got["B"]
    wide_chunks = -(-8_192 // chunk_rows(80_000, 4))
    parts = topk.multipass_parts(80_000, m_wide + 1)
    check(wide_a == parts * wide_chunks and wide_b == got["F"] == wide_chunks,
          f"kernel A launched {wide_a} times ({parts} parts x {wide_chunks} chunks);"
          f" kernel B {wide_b} times (one merge per chunk), kernel F {got['F']}")
    print(f"  time  loo() {timed_wide['wall_s']:.3f} s wall, scoring"
          f" {timed_wide['scoring_s']:.3f} s; peak device memory {timed_wide['peak_gb']:.2f} GB",
          flush=True)

    # the plain scorer on the card, on the first rows of each run
    for name, ll, result, m, n_rows in [
        ("1M x 4000", ll_host, res, m_tail, 65_536),
        ("8192 x 80000", ll_wide, res_wide, m_wide, 2_048),
    ]:
        x = obs_major(ll, n_rows)
        fused = loo_scores_psis_fast(x, m)
        zero_counts()
        plain = loo_scores_psis_fast(x, m, route="torch")
        launched = read_counts(main_path=False)
        check(not any(launched.values()), f"{name}: the plain scorer launched no kernel"
              f" ({launched})")
        e, k_plain, dg_plain = (plain[0].cpu().numpy(), plain[1].cpu().numpy(), plain[3].cpu().numpy())
        ok = (
            np.allclose(result.loo_i.values[:n_rows], e, rtol=1e-5, atol=1e-5)
            and np.abs(result.pareto_k.values[:n_rows] - k_plain).max() <= 1e-3
            and np.array_equal(fused[3].cpu().numpy(), dg_plain)
        )
        check(ok, f"{name}: first {n_rows} rows against the plain scorer on the card"
              f" (loo_i max |err| {np.abs(result.loo_i.values[:n_rows] - e).max():.3g},"
              f" k max |err| {np.abs(result.pareto_k.values[:n_rows] - k_plain).max():.3g},"
              f" degenerate flags identical)")
        del x, fused, plain
    return ll_host, beta, model, res, timed


def tail_counts(ll_rows, m: int, floor: float):
    """PSIS tail length per row (strictly above the cutoff), in the rows' dtype."""
    import torch

    out = []
    for block in ll_rows.split(65_536):
        x = -block
        vals = torch.topk(x - x.amax(dim=1, keepdim=True), m + 1, dim=1).values
        cut = vals[:, m].clamp_min(floor)
        out.append((vals[:, :m] > cut[:, None]).sum(dim=1))
    return torch.cat(out).cpu().numpy()


def phase_float64(pl, ll_host, beta, res32):
    import numpy as np

    from pyloo_tpu_torch._common import compute_reff
    from pyloo_tpu_torch.ops.loo_kernels import loo_scores_psis_fast
    from pyloo_tpu_torch.ops.psis import tail_length
    from pyloo_tpu_torch.ops.topk import _CUTOFF_FLOOR

    print("phase 3: loo() float64 (the default) on the first 250,000 observations", flush=True)
    n_rows = 250_000
    ll = np.ascontiguousarray(ll_host[:, :, :n_rows])
    idata = pl.from_dict(posterior={"beta": beta}, log_likelihood={"y": ll})
    pl.rcParams["device.precision"] = "float64"
    timed: dict = {}
    zero_counts()
    res = run_loo(pl, idata, timed)
    got = read_counts()
    check(not any(got.values()), f"float64 bypasses the kernels: launches {got}")
    print(f"  time  loo() float64 {timed['wall_s']:.3f} s wall, scoring"
          f" {timed['scoring_s']:.3f} s, {n_rows / timed['wall_s']:.0f} obs/s; peak device"
          f" memory {timed['peak_gb']:.2f} GB", flush=True)

    m_tail = tail_length(4_000, compute_reff(idata, None, 4_000))
    x32 = obs_major(ll_host, n_rows)
    degen = loo_scores_psis_fast(x32, m_tail)[3].cpu().numpy()
    # float32 rounding can merge two values that straddle the float64 cutoff,
    # so the strict-> tail gains or loses one element and k moves by ~k/M:
    # such rows are counted and reported, and k is held to the envelope on the rest
    same_tail = tail_counts(x32, m_tail, _CUTOFF_FLOOR) == tail_counts(
        x32.double(), m_tail, _CUTOFF_FLOOR
    )
    del x32
    e64, k64 = res.loo_i.values, res.pareto_k.values
    e32, k32 = res32.loo_i.values[:n_rows], res32.pareto_k.values[:n_rows]
    ok_rows = ~degen & np.isfinite(e64) & np.isfinite(k64)
    d_e = np.abs(e32 - e64)[ok_rows].max()
    d_k = np.abs(k32 - k64)[ok_rows & same_tail].max()
    moved = ok_rows & ~same_tail
    d_k_moved = np.abs(k32 - k64)[moved].max() if moved.any() else 0.0
    check(
        np.allclose(e32[ok_rows], e64[ok_rows], rtol=1e-4, atol=1e-4) and d_k <= 2e-3,
        f"float32 against float64 on {ok_rows.sum()} non-degenerate rows: max |d elpd_i|"
        f" {d_e:.3g} (rtol 1e-4, atol 1e-4); max |d k| {d_k:.3g} (atol 2e-3) on the"
        f" {(ok_rows & same_tail).sum()} rows whose tail length agrees; {moved.sum()} rows"
        f" whose float32 tail is one element off, max |d k| {d_k_moved:.3g}",
    )
    return res


def phase_streaming(pl, ll_host, model, reff: float, res32, res64) -> dict:
    import numpy as np
    import torch

    from pyloo_tpu_torch.ops.psis import tail_length
    from pyloo_tpu_torch.ops.topk import _CUTOFF_FLOOR, overflow_rows
    from pyloo_tpu_torch.streaming._chunks import resolve_chunk
    from bench_torch import model as bench_model

    print("phase 5: loo_streaming float32 at 1,000,000 x 4,000, the model on the card",
          flush=True)
    xw, _, beta = model
    n_obs, s = xw.shape[0], beta.shape[0] * beta.shape[1]
    log_lik_fn = bench_model.log_lik_fn(model)

    m_tail = tail_length(s, reff)
    chunk, n_chunks = resolve_chunk(None, n_obs, s, torch.float32)
    overflow_rows(reset=True)
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = pl.loo_streaming(log_lik_fn, n_obs, s, reff=reff, dtype="float32", pointwise=True)
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = read_counts()
    n_over = overflow_rows(reset=True)
    check(got["A"] == got["F"] == n_chunks and got["B"] == got["C"] == got["D"] == got["E"] == 0,
          f"kernels A and F launched {got['A']} and {got['F']} times for {n_chunks} chunks of"
          f" {chunk}; kernel B {got['B']}")
    print(f"  time  loo_streaming() {wall:.3f} s wall, {n_obs / wall:.0f} obs/s; peak device"
          f" memory {peak:.2f} GB; elpd_loo {res['elpd_loo']:.6f}, loo() {res32['elpd_loo']:.6f}",
          flush=True)
    print(f"  rows  kernel A narrowed {n_over} of {n_obs} rows ({100 * n_over / n_obs:.2f}%) by a"
          f" further digit", flush=True)

    # where one chunk's time goes (CUDA events, median of 3, the first chunk)
    from pyloo_tpu_torch.base import ISMethod
    from pyloo_tpu_torch.ops.loo_kernels import loo_scores_psis_fast
    from pyloo_tpu_torch.ops.topk import loo_prepass
    from pyloo_tpu_torch.streaming import _accumulate, _chunks

    idx, valid = _chunks.chunk_indices(0, chunk, n_obs, torch.device("cuda"))
    ll = log_lik_fn(idx)
    carry = _accumulate.init_carry(ISMethod.PSIS, False, torch.float32, 0.7, ll.device)
    x = -ll
    stage = {
        "generator": median_ms(lambda: log_lik_fn(idx), 3),
        "kernel A": median_ms(lambda: loo_prepass(x, m_tail + 1), 3),
        "scorer (kernel A, fit, reductions)": median_ms(lambda: loo_scores_psis_fast(ll, m_tail), 3),
        "scorer + running sums": median_ms(lambda: _accumulate.accumulate_chunk(
            ll, valid, carry, method=ISMethod.PSIS, tail_max=m_tail), 3),
    }
    del ll, x
    print("  time  one chunk of " + str(chunk) + " rows: "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in stage.items())
          + f"; x {n_chunks} chunks = {n_chunks * (stage['generator'] + stage['scorer + running sums']) / 1e3:.3f} s"
          " of device work", flush=True)

    # the same rows as phase 2's matrix: the products are rounded in another
    # order, so a row's tail length may move by one; those rows are counted
    same_tail = np.empty(n_obs, bool)
    ll_rows_differ = 0
    for c in range(n_chunks):
        start = c * chunk
        n = min(chunk, n_obs - start)
        made = log_lik_fn(torch.arange(start, start + n, device="cuda"))
        stored = obs_major(ll_host, n, start)
        ll_rows_differ += int((made != stored).any(dim=1).sum())
        same_tail[start : start + n] = (
            tail_counts(made, m_tail, _CUTOFF_FLOOR) == tail_counts(stored, m_tail, _CUTOFF_FLOOR)
        )
        del made, stored
    e_s, k_s = res.loo_i.values, res.pareto_k.values
    e_l, k_l = res32.loo_i.values, res32.pareto_k.values
    k_close = np.isclose(k_s, k_l, rtol=0, atol=1e-3)
    d_k = np.abs(k_s - k_l)
    check(
        np.allclose(e_s, e_l, rtol=1e-5, atol=1e-5) and k_close[same_tail].all(),
        f"against loo(): max |d loo_i| {np.abs(e_s - e_l).max():.3g} (rtol 1e-5, atol 1e-5);"
        f" max |d k| {np.nan_to_num(d_k[same_tail]).max():.3g} (atol 1e-3) on the"
        f" {same_tail.sum()} rows whose tail length agrees; {(~same_tail).sum()} rows whose"
        f" tail length differs, max |d k| {np.nan_to_num(d_k[~same_tail], nan=0).max(initial=0):.3g};"
        f" {ll_rows_differ} rows of the made log-likelihood differ from phase 2's;"
        f" loo_i differs at all on {(e_s != e_l).sum()} rows",
    )
    phase5 = {"elpd_loo": res["elpd_loo"], "n_chunks": n_chunks, "chunk": chunk, "wall_s": wall,
              "digest": result_digest(res), "loo_i": res.loo_i.values,
              "pareto_k": res.pareto_k.values}  # phase 14 holds its clean rows to them
    del res

    print("phase 5b: loo_streaming over the first 250,000 rows of the phase-2 matrix",
          flush=True)
    n_rows = 250_000
    rows = obs_major(ll_host, n_rows)
    for dtype, ref, tol in [("float32", res32, 1e-6), ("float64", res64, 1e-12)]:
        src = rows if dtype == "float32" else rows.double()
        n_chunks = resolve_chunk(None, n_rows, s, getattr(torch, dtype))[1]
        zero_counts()
        out = pl.loo_streaming(lambda idx: src[idx], n_rows, s, reff=reff, dtype=dtype,
                               pointwise=True)
        got = read_counts()
        want_a = n_chunks if dtype == "float32" else 0
        check(got["A"] == got["F"] == want_a and got["B"] == 0,
              f"{dtype}: kernels A and F launched {got['A']} and {got['F']} times ({want_a}"
              " expected)")
        e, k = out.loo_i.values, out.pareto_k.values
        e_ref, k_ref = ref.loo_i.values[:n_rows], ref.pareto_k.values[:n_rows]
        differ = ~((e == e_ref) | (np.isnan(e) & np.isnan(e_ref))) | ~(
            (k == k_ref) | (np.isnan(k) & np.isnan(k_ref)))
        check(
            np.allclose(e, e_ref, rtol=tol, atol=tol, equal_nan=True)
            and np.allclose(k, k_ref, rtol=tol, atol=tol, equal_nan=True),
            f"{dtype}: loo_i and k against loo() on the same rows within rtol/atol {tol:g}"
            f" ({n_chunks} chunks against loo()'s own); {differ.sum()} rows differ at all,"
            f" max |d loo_i| {np.nan_to_num(np.abs(e - e_ref)).max():.3g},"
            f" max |d k| {np.nan_to_num(np.abs(k - k_ref), posinf=0).max():.3g}",
        )
        if dtype == "float32":  # phase 8 holds loo_from_file to it
            phase5["5b"] = (e, k)
        del src, out
    return phase5



def result_digest(res) -> str:
    """SHA-256 of a pointwise result's loo_i and pareto_k bytes."""
    import hashlib

    import numpy as np

    digest = hashlib.sha256(np.ascontiguousarray(res.loo_i.values).tobytes())
    digest.update(np.ascontiguousarray(res.pareto_k.values).tobytes())
    return digest.hexdigest()


def smoke_mesh():
    """The mesh of the sharded checks: ``obs_mesh()`` (every card) with two
    cards or more, else four shards of ``cuda:0``, which run the split, each
    shard's launches and the merge on one card."""
    from pyloo_tpu_torch.parallel import Mesh, obs_mesh

    mesh = obs_mesh()
    return mesh if mesh is not None else Mesh(["cuda:0"] * 4)


@contextlib.contextmanager
def default_mesh_of(mesh):
    """``obs_mesh()``, the default mesh of ``loo()``, ``loo_nonfactor`` and
    moment matching, made to see ``mesh``'s devices for the block."""
    from pyloo_tpu_torch.parallel import sharding

    real = sharding._visible_devices
    sharding._visible_devices = lambda: list(mesh.devices)
    try:
        yield
    finally:
        sharding._visible_devices = real


def timed_call(what: str, fn, timings: dict, main_path: bool = True):
    """``fn()`` with its wall time (a host clock around a call that ends
    synchronised) and its peak device memory, printed and kept.

    A main-path call is a launch window of its own: the kernels' counters
    are set to 0 just before it and read just after, so the launches kept
    beside its time are that call's alone and none of a check's.
    """
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if main_path:
        zero_counts()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 1e9
    timings[what] = {"wall_s": wall, "peak_gb": peak}
    launched = ""
    if main_path:
        got = read_counts()
        timings[what]["launches"] = {name: got[name] for name in "ABCD"}
        launched = ", launches " + " ".join(f"{name} {got[name]}" for name in "ABCD")
    print(f"  time  {what}: {wall:.3f} s wall, peak device memory {peak:.2f} GB{launched}",
          flush=True)
    return out


def card_rows(fn, *host_arrays, chunk: int = 65_536):
    """``fn`` over row chunks of host arrays copied to the card; per-row results on the host."""
    import torch

    outs = []
    for start in range(0, host_arrays[0].shape[0], chunk):
        blocks = [torch.from_numpy(a[start : start + chunk]).cuda() for a in host_arrays]
        outs.append(fn(*blocks).cpu())
    return torch.cat(outs).numpy()


def on_cpu(pl, fn):
    """``fn()`` with ``rcParams["device.device"] = "cpu"``, then the device
    it had."""
    device = pl.rcParams["device.device"]
    pl.rcParams["device.device"] = "cpu"
    try:
        return fn()
    finally:
        pl.rcParams["device.device"] = device


def phase_weights(pl, ll_host, beta, res32, smi: str, n_rows: int = 262_144,
                  n_cut: int = 4_096):
    import numpy as np
    import torch

    from pyloo_tpu_torch._common import compute_reff
    from pyloo_tpu_torch.ops.psis import tail_length
    from pyloo_tpu_torch.ops.selection import topk_with_idx

    n_obs, s = ll_host.shape[2], ll_host.shape[0] * ll_host.shape[1]
    print(f"phase 6: the importance-weights path at {n_rows} x {s} float32 ({smi})", flush=True)
    pl.rcParams["device.device"] = "cuda"
    pl.rcParams["device.precision"] = "float32"
    idata_all = pl.from_dict(posterior={"beta": beta}, log_likelihood={"y": ll_host})
    reff = compute_reff(idata_all, None, s)
    m_tail = tail_length(s, reff)
    ll_rows = obs_major(ll_host, n_rows).cpu().numpy()  # (n_rows, S), as loo() lays it out
    neg = -ll_rows
    loo_i32, k32 = res32.loo_i.values[:n_rows], res32.pareto_k.values[:n_rows]
    timings: dict = {}
    lse = lambda a: torch.logsumexp(a, dim=1)  # noqa: E731

    # psislw against loo(): the float32 envelope of phase 3 (k 2e-3, elpd rtol/atol 1e-4)
    lw, k = timed_call("psislw", lambda: pl.psislw(neg, reff=reff), timings)
    elpd = card_rows(lambda a, b: lse(a + b), lw, ll_rows)
    sums = card_rows(lambda a: lse(a).exp(), lw)
    bad_k = int((~(np.abs(k - k32) <= 2e-3)).sum())
    bad_e = int((~np.isclose(elpd, loo_i32, rtol=1e-4, atol=1e-4)).sum())
    check(lw.shape == (n_rows, s) and lw.dtype == np.float32 and bad_k == 0 and bad_e == 0,
          f"psislw against loo(): {bad_k} rows with |d k| > 2e-3 (max"
          f" {np.nanmax(np.abs(k - k32)):.3g}), {bad_e} rows with logsumexp(lw + ll) outside"
          f" rtol/atol 1e-4 of loo_i (max |d| {np.nanmax(np.abs(elpd - loo_i32)):.3g})")
    check(bool((np.abs(sums - 1.0) <= 1e-5).all()),
          f"every row's weights sum to 1 within 1e-5 (max |sum - 1| {np.abs(sums - 1.0).max():.3g})")

    # the compact form against the dense one
    compact = timed_call("psislw_compact", lambda: pl.psislw_compact(neg, reff=reff), timings)
    dense = timed_call("CompactWeights.densify", lambda: compact.densify(neg), timings)
    d_dense = card_rows(lambda a, b: (a - b).abs().amax(dim=1), dense, lw)
    close = card_rows(lambda a, b: torch.isclose(a, b, rtol=1e-5, atol=1e-5).all(dim=1), dense, lw)
    check(bool(close.all()) and np.array_equal(compact.pareto_k, k, equal_nan=True),
          f"densify against psislw within rtol/atol 1e-5 (max |d| {d_dense.max():.3g}); k identical")
    del dense
    h = np.exp(ll_rows)  # the likelihood: its LOO expectation is exp(loo_i)
    mean_c = timed_call("CompactWeights.weighted_mean", lambda: compact.weighted_mean(h, neg),
                        timings)
    h_da = pl.DataArray(h, ("obs", "__sample__"))
    lw_da = pl.DataArray(lw, ("obs", "__sample__"))
    mean = timed_call("e_loo mean",
                      lambda: pl.e_loo(h_da, log_weights=lw_da, type="mean"), timings)
    check(np.allclose(mean_c, mean.value.values, rtol=1e-4, atol=1e-7)
          and np.allclose(mean.value.values, np.exp(loo_i32), rtol=2e-4, atol=1e-7),
          f"weighted_mean(h) against e_loo(mean) with the dense weights (rtol 1e-4, max rel"
          f" {np.abs(mean_c / mean.value.values - 1).max():.3g}); e_loo(mean) of the likelihood"
          f" against exp(loo_i) of loo() (rtol 2e-4, max rel"
          f" {np.abs(mean.value.values / np.exp(loo_i32) - 1).max():.3g})")
    del compact

    # e_loo variance and quantile: against the CPU on the first 4,096 rows
    cut = lambda a: a[:n_cut]  # noqa: E731
    h_cut = pl.DataArray(cut(h), ("obs", "__sample__"))
    lw_cut = pl.DataArray(cut(lw), ("obs", "__sample__"))
    probs = [0.05, 0.5, 0.95]
    var = timed_call("e_loo variance",
                     lambda: pl.e_loo(h_da, log_weights=lw_da, type="variance"), timings)
    qua = timed_call("e_loo quantile (3 probabilities)",
                     lambda: pl.e_loo(h_da, log_weights=lw_da, type="quantile", probs=probs),
                     timings)
    var_cpu = on_cpu(pl, lambda: pl.e_loo(h_cut, log_weights=lw_cut, type="variance"))
    qua_cpu = on_cpu(pl, lambda: pl.e_loo(h_cut, log_weights=lw_cut, type="quantile",
                                          probs=probs))
    q = qua.value.values
    check(np.allclose(cut(var.value.values), var_cpu.value.values, rtol=1e-3, atol=1e-6)
          and np.allclose(cut(var.pareto_k.values), var_cpu.pareto_k.values, atol=2e-3),
          f"e_loo(variance) against the CPU on {n_cut} rows (rtol 1e-3, atol 1e-6; k atol 2e-3: max |d k|"
          f" {np.abs(cut(var.pareto_k.values) - var_cpu.pareto_k.values).max():.3g})")
    check(q.shape == (n_rows, 3) and bool((np.diff(q, axis=1) >= 0).all())
          and np.allclose(cut(q), qua_cpu.value.values, rtol=1e-4, atol=1e-7),
          f"e_loo(quantile) {q.shape}, ordered in the probabilities, against the CPU on {n_cut}"
          f" rows (rtol 1e-4; max rel {np.abs(cut(q) / qua_cpu.value.values - 1).max():.3g})")
    del h, h_da, lw_da, var, qua, mean

    # the readers that smooth the weights themselves, on the same rows
    ll_cut_host = np.ascontiguousarray(ll_host[:, :, :n_rows])
    idata = pl.from_dict(posterior={"beta": beta}, log_likelihood={"y": ll_cut_host})
    small = pl.from_dict(posterior={"beta": beta},
                         log_likelihood={"y": np.ascontiguousarray(ll_host[:, :, :n_cut])})
    ess = timed_call("psis_ess_values", lambda: pl.psis_ess_values(idata), timings)
    ess_lw = card_rows(lambda a: 1.0 / (2.0 * a).exp().sum(dim=1), lw)
    check(np.allclose(ess, ess_lw, rtol=1e-4),
          f"psis_ess_values against 1 / sum(exp(2 lw)) of psislw's weights (rtol 1e-4, max rel"
          f" {np.abs(ess / ess_lw - 1).max():.3g}; ESS {ess.min():.0f} to {ess.max():.0f})")
    mcse = timed_call("mcse_loo (pointwise)", lambda: pl.mcse_loo(idata, pointwise=True), timings)
    mcse_cpu = on_cpu(pl, lambda: pl.mcse_loo(small, pointwise=True))
    check(np.array_equal(np.isnan(mcse), (k > 0.7) | np.isnan(k))
          and np.allclose(cut(mcse), mcse_cpu, rtol=1e-3, atol=1e-7, equal_nan=True),
          f"mcse_loo: NaN exactly where k > 0.7 ({int(np.isnan(mcse).sum())} rows); against the"
          f" CPU on {n_cut} rows (rtol 1e-3; total {np.sqrt(np.nansum(mcse ** 2)):.4f})")

    groups = np.arange(n_rows) % 1_000
    logo = timed_call("loo_group (1,000 groups)",
                      lambda: pl.loo_group(idata, groups, pointwise=True), timings)
    logo_small = pl.loo_group(small, groups[:n_cut] % 16, pointwise=True)
    logo_cpu = on_cpu(pl, lambda: pl.loo_group(small, groups[:n_cut] % 16, pointwise=True))
    check(logo["n_groups"] == 1_000 and np.isfinite(logo.logo_i.values).all()
          and np.allclose(logo_small.logo_i.values, logo_cpu.logo_i.values, rtol=1e-4)
          and np.allclose(logo_small.pareto_k, logo_cpu.pareto_k, atol=5e-3),
          f"loo_group: 1,000 finite logo_i, elpd_logo {logo['elpd_logo']:.2f}; 16 groups of the"
          f" first {n_cut} rows against the CPU (logo_i rtol 1e-4, k atol 5e-3: max |d k|"
          f" {np.abs(logo_small.pareto_k - logo_cpu.pareto_k).max():.3g})")
    del idata, ll_cut_host

    # waic over the whole matrix: its lppd is loo()'s
    waic = timed_call(f"waic ({n_obs} x {s})", lambda: pl.waic(idata_all, pointwise=True),
                      timings)
    lppd_waic = waic["elpd_waic"] + waic["p_waic"]
    lppd_loo = res32["elpd_loo"] + res32["p_loo"]
    waic_small = pl.waic(small, pointwise=True)
    waic_cpu = on_cpu(pl, lambda: pl.waic(small, pointwise=True))
    check(np.isfinite(waic.waic_i.values).all() and abs(lppd_waic / lppd_loo - 1) <= 1e-5
          and np.allclose(waic_small.waic_i.values, waic_cpu.waic_i.values, rtol=1e-5, atol=1e-5),
          f"waic: elpd_waic {waic['elpd_waic']:.3f}, p_waic {waic['p_waic']:.3f}; its lppd against"
          f" loo()'s (rel {abs(lppd_waic / lppd_loo - 1):.3g}, 1e-5); waic_i against the CPU on"
          f" {n_cut} rows (rtol/atol 1e-5)")

    for i in (0, n_rows // 2 - 1, n_obs - 1):
        one = timed_call(f"loo_i({i})", lambda: pl.loo_i(i, idata_all, pointwise=True), timings)
        d_e = abs(one["elpd_loo"] - res32.loo_i.values[i])
        d_k = abs(one["pareto_k"][0] - res32.pareto_k.values[i])
        check(d_e <= 1e-4 * (1 + abs(one["elpd_loo"])) and d_k <= 2e-3,
              f"loo_i({i}) against row {i} of loo(): |d elpd| {d_e:.3g} (rtol/atol 1e-4),"
              f" |d k| {d_k:.3g} (2e-3)")
    del idata_all

    launched = {what: t["launches"] for what, t in timings.items() if any(t["launches"].values())}
    print(f"  count launches of the kernels in phase 6, each public call a window of its own: "
          + ("; ".join(what + ": " + " ".join(f"{name} {n}" for name, n in got.items() if n)
                       for what, got in launched.items()) or "none")
          + f"; the other {len(timings) - len(launched)} calls launch none of A to D (this path"
          f" selects with indices: torch.topk; loo_group's exact scorer selects values, in"
          f" float32 through kernel B)", flush=True)

    # float64 on the card against the CPU: 4,096 rows and 512 rows with ties
    pl.rcParams["device.precision"] = "float64"
    rows64 = neg[:n_cut].astype(np.float64)
    rows64 = np.concatenate([rows64, np.round(rows64[:512], 2)])
    lw_card, k_card = timed_call(f"psislw float64 ({rows64.shape[0]} rows)",
                                 lambda: pl.psislw(rows64, reff=reff), timings, main_path=False)
    t = time.perf_counter()
    lw_cpu, k_cpu = on_cpu(pl, lambda: pl.psislw(rows64, reff=reff))
    print(f"  time  the same call on the CPU: {time.perf_counter() - t:.3f} s", flush=True)
    n_ties = int((np.diff(np.sort(rows64[n_cut:], axis=1), axis=1) == 0).sum(axis=1).min())
    check(np.allclose(lw_card, lw_cpu, rtol=1e-10, atol=1e-10)
          and np.allclose(k_card, k_cpu, rtol=1e-10, atol=1e-10),
          f"float64 psislw on the card against the CPU within 1e-10: max |d lw|"
          f" {np.abs(lw_card - lw_cpu).max():.3g}, max |d k| {np.abs(k_card - k_cpu).max():.3g}"
          f" (the last 512 rows rounded to 2 decimals: at least {n_ties} tied pairs a row)")
    pl.rcParams["device.precision"] = "float32"

    # where psislw's wall goes: the copy in, the device work, the copy out
    from pyloo_tpu_torch.base import _WEIGHTS_EXTRA_BUFFERS, as_sample_matrix
    from pyloo_tpu_torch.ops.psis import _select_tail, _smoothed_tail_desc, psislw_batch
    from pyloo_tpu_torch.parallel import apply_rowwise

    matrix = timed_call("psislw, its parts: as_sample_matrix (the copy in)",
                        lambda: as_sample_matrix(neg)[0], timings, main_path=False)
    on_card = timed_call(
        "psislw, its parts: apply_rowwise(psislw_batch) (the device work)",
        lambda: apply_rowwise(lambda b: psislw_batch(b, m_tail), matrix,
                              extra_buffers=_WEIGHTS_EXTRA_BUFFERS), timings, main_path=False)
    timed_call("psislw, its parts: the weights' copy to the host",
               lambda: on_card[0].cpu().numpy(), timings, main_path=False)
    del on_card
    x = matrix[:65_536] - matrix[:65_536].amax(dim=1, keepdim=True)
    vals, _, xcutoff = _select_tail(x, m_tail)
    stage = {
        "psislw_batch": median_ms(lambda: psislw_batch(matrix[:65_536], m_tail), 3),
        "its fit and smoothing (_smoothed_tail_desc)": median_ms(
            lambda: _smoothed_tail_desc(vals[:, :m_tail], xcutoff, m_tail), 3),
    }
    print(f"  time  one chunk of {x.shape[0]} rows: "
          + ", ".join(f"{name} {t:.3f} ms" for name, t in stage.items()), flush=True)
    del matrix, vals

    # the two ways of ordering ties, at one chunk of psislw's and at wider rows
    gen = torch.Generator(device="cuda").manual_seed(6)
    shapes = [("psislw's chunk", x, m_tail + 1)]
    for rows, width in ((16_384, 16_000), (4_096, 32_768)):
        shapes.append(("normal rows", torch.randn(rows, width, device="cuda", generator=gen),
                       tail_length(width) + 1))
    shapes.append(("float64", x[:32_768].double(), m_tail + 1))
    del x
    def row_sort(x, k):  # the alternative: one stable descending sort of the row, cut at k
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals[..., :k].contiguous(), idx[..., :k].contiguous()

    for what, x, k in shapes:
        got, alt = topk_with_idx(x, k), row_sort(x, k)
        strict = alt[0] > alt[0][:, -1:]
        check(torch.equal(got[0], alt[0]) and torch.equal(got[1][strict], alt[1][strict]),
              f"topk_with_idx {tuple(x.shape)} k={k}, {what}: the values of a stable descending"
              f" row sort cut at k, and its indices above the k-th value")
        del got, alt, strict
        ms = {name: median_ms(lambda: fn(x, k))
              for name, fn in (("topk_with_idx", topk_with_idx), ("row sort", row_sort),
                               ("topk_with_idx again", topk_with_idx))}
        ms["torch.topk alone"] = median_ms(lambda: torch.topk(x, k, dim=1))
        print(f"  time  topk_with_idx {tuple(x.shape)} k={k}, {what}: "
              + ", ".join(f"{name} {t:.3f} ms" for name, t in ms.items()), flush=True)
    del shapes, x
    print(f"  card  {smi}", flush=True)
    return waic


_M32 = 0xFFFFFFFF


def _mix32(h):
    """A 32-bit integer hash (two multiply-xorshift rounds) of an int64
    tensor of values below 2**32; the products stay below 2**63."""
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
    return h ^ (h >> 16)


def bernoulli_draws(idx, eta, which: int):
    """Posterior-predictive draws Bernoulli(sigmoid(eta)) of the rows ``idx``,
    from a counter-based hash of (row, draw, set): a row's draws are the same
    whenever and in whatever chunk they are made."""
    import torch

    draws = torch.arange(eta.shape[1], device=eta.device, dtype=torch.int64)
    row = _mix32((idx.to(torch.int64) * 2 + which) & _M32)
    h = _mix32(row[:, None] ^ ((draws * 0x9E3779B1) & _M32)[None, :])
    u = (h >> 8).to(torch.float32) * 2.0**-24
    return (u < torch.sigmoid(eta)).to(eta.dtype)


def phase_scoring(pl, ll_host, beta, model, reff: float, res32, phase5: dict, waic32,
                  smi: str) -> None:
    import warnings

    import numpy as np
    import torch

    from pyloo_tpu_torch.compare import _DEVICE_SOLVER_MIN_OBS
    from pyloo_tpu_torch.ops import stacking
    from pyloo_tpu_torch.ops.psis import psislw_batch, tail_length
    from pyloo_tpu_torch.streaming import _chunks
    from pyloo_tpu_torch.streaming.score import SCORE_CHUNK_BUDGET

    score_mod = sys.modules["pyloo_tpu_torch.loo_score"]
    stream_compare = sys.modules["pyloo_tpu_torch.streaming.compare"]
    xw, yw, beta_c = model
    chains, draws = beta_c.shape[0], beta_c.shape[1]
    n_obs, s = xw.shape[0], chains * draws
    print(f"phase 7: scoring and model comparison at {n_obs} x {s} ({smi})", flush=True)
    pl.rcParams["device.device"] = "cuda"
    pl.rcParams["device.precision"] = "float32"
    beta1 = beta_c.reshape(s, -1)  # sample = chain * draws + draw, as loo() stacks them
    beta2 = beta1.clone()
    beta2[:, 16:] = 0.0  # model 2: features 16-31 dropped from every draw
    # model 2's posterior: the 16 features it keeps (the dropped ones are constant)
    beta2_host = beta2.reshape(chains, draws, -1)[:, :, :16].cpu().numpy()
    zero = xw.new_zeros(())

    def log_lik(b):
        def fn(idx):
            eta = xw[idx] @ b.T  # (chunk, S), full float32 (no TF32)
            return yw[idx, None] * eta - torch.logaddexp(eta, zero)
        return fn

    def predictive(which):
        return lambda idx: bernoulli_draws(idx, xw[idx] @ beta1.T, which)

    ll1, ll2, x_fn, x2_fn = log_lik(beta1), log_lik(beta2), predictive(0), predictive(1)
    timings: dict = {}

    # the EM solver's calls and the elpds loo_compare_streaming ranks, recorded
    em_calls, captured = [], {}
    real_em, real_compare = stacking._em_solve, stream_compare.loo_compare

    def recording_em(exp_elpds, max_iters, tol):
        torch.cuda.synchronize()
        t = time.perf_counter()
        w, turns = real_em(exp_elpds, max_iters, tol)
        torch.cuda.synchronize()
        em_calls.append({"device": exp_elpds.device.type, "shape": tuple(exp_elpds.shape),
                         "turns": turns, "s": time.perf_counter() - t})
        return w, turns

    def capturing_compare(elpds, **kwargs):
        captured.clear()
        captured.update(elpds)
        return real_compare(elpds, **kwargs)

    stacking._em_solve, stream_compare.loo_compare = recording_em, capturing_compare
    try:
        # (a) loo_compare_streaming, ic="loo", stacking
        print("phase 7a: loo_compare_streaming, ic='loo', stacking, models 1 and 2", flush=True)
        table = timed_call("loo_compare_streaming (loo, stacking)", lambda: pl.loo_compare_streaming(
            {"m1": ll1, "m2": ll2}, n_obs, s, reff=reff, dtype="float32"), timings)
        got = timings["loo_compare_streaming (loo, stacking)"]["launches"]
        want_a = 2 * phase5["n_chunks"]
        check(got["A"] == want_a and got["B"] == got["C"] == got["D"] == 0,
              f"kernel A launched {got['A']} times ({want_a}: 2 models x phase 5's"
              f" {phase5['n_chunks']} chunks); B {got['B']}, C {got['C']}, D {got['D']}")
        em = em_calls[-1] if em_calls else {}
        check(len(em_calls) == 1 and em["device"] == "cuda" and n_obs >= _DEVICE_SOLVER_MIN_OBS,
              f"stacking by the EM solver on the card ({em.get('shape')}, {em.get('turns')} turns,"
              f" {1e3 * em.get('s', 0):.1f} ms; n_obs {n_obs} >= {_DEVICE_SOLVER_MIN_OBS})")
        m1 = captured["m1"]
        check(m1["elpd_loo"] == phase5["elpd_loo"],
              f"model 1's elpd_loo {m1['elpd_loo']:.6f} equals phase 5's {phase5['elpd_loo']:.6f}")
        again = pl.loo_compare(dict(captured))
        same = again.index == table.index and all(
            np.array_equal(again[c], table[c]) for c in table.columns)
        check(same, "the table equals loo_compare over the two streaming ELPDData (precomputed)")
        mixed = pl.loo_compare({"m1": res32, "m2": captured["m2"]})
        d_w = np.abs(mixed["weight"] - table["weight"]).max()
        d_e = np.abs(mixed["elpd_loo"] / table["elpd_loo"] - 1).max()
        check(mixed.index == table.index and d_w <= 1e-3 and d_e <= 1e-6,
              f"the table over phase 2's loo() for model 1: max |d weight| {d_w:.3g} (1e-3),"
              f" max rel d elpd_loo {d_e:.3g} (1e-6)")
        print("  table\n" + "\n".join("    " + line for line in str(table).splitlines()),
              flush=True)
        captured_loo = dict(captured)

        # (b) the same with ic="waic"
        print("phase 7b: loo_compare_streaming, ic='waic'", flush=True)
        table_w = timed_call("loo_compare_streaming (waic, stacking)",
                             lambda: pl.loo_compare_streaming({"m1": ll1, "m2": ll2}, n_obs, s,
                                                              ic="waic", dtype="float32"), timings)
        got = timings["loo_compare_streaming (waic, stacking)"]["launches"]
        check(not any(got.values()), f"waic streaming launches none of A-D ({got})")
        w_s, w_l = captured["m1"].waic_i.values, waic32.waic_i.values
        d = np.abs(w_s - w_l)
        check(np.allclose(w_s, w_l, rtol=1e-4, atol=1e-4),
              f"model 1's waic_i against phase 6's stored waic (rtol/atol 1e-4: max |d|"
              f" {d.max():.3g}, {(d > 0).sum()} rows differ at all); elpd_waic"
              f" {table_w['elpd_waic'][0]:.3f}, {em_calls[-1]['turns']} EM turns")
    finally:
        stacking._em_solve, stream_compare.loo_compare = real_em, real_compare

    # (c) loo_compare on stored matrices
    n_rows, n_cut = 250_000, 50_000
    print(f"phase 7c: loo_compare on the stored first {n_rows} rows of each model", flush=True)
    ll2_host = np.empty((chains, draws, n_rows), np.float32)
    for start in range(0, n_rows, 50_000):
        block = ll2(torch.arange(start, min(start + 50_000, n_rows), device="cuda"))
        ll2_host[:, :, start : start + block.shape[0]] = (
            block.T.reshape(chains, draws, -1).cpu().numpy())
        del block
    ll1_host = np.ascontiguousarray(ll_host[:, :, :n_rows])
    stored = {"m1": pl.from_dict(posterior={"beta": beta}, log_likelihood={"y": ll1_host}),
              "m2": pl.from_dict(posterior={"beta": beta2_host}, log_likelihood={"y": ll2_host})}
    n_em = len(em_calls)
    stacking._em_solve = recording_em
    try:
        table_c = timed_call(f"loo_compare (stored {n_rows} rows, stacking)",
                             lambda: pl.loo_compare(stored), timings)
    finally:
        stacking._em_solve = real_em
    got = timings[f"loo_compare (stored {n_rows} rows, stacking)"]["launches"]
    check(got["A"] == 4 and got["B"] == got["C"] == got["D"] == 0 and len(em_calls) == n_em + 1,
          f"loo() per model: kernel A launched {got['A']} times (2 a model), B {got['B']};"
          f" stacking by the EM solver on the card ({em_calls[-1]['turns']} turns)")
    want = float(np.sum(res32.loo_i.values[:n_rows], dtype=np.float64))
    i1 = table_c.index.index("m1")
    check(abs(table_c["elpd_loo"][i1] / want - 1) <= 1e-6,
          f"model 1's elpd_loo {table_c['elpd_loo'][i1]:.4f} is the sum of phase 2's first"
          f" {n_rows} loo_i ({want:.4f} summed in float64; loo() sums in float32: rel 1e-6)")
    print("  table\n" + "\n".join("    " + line for line in str(table_c).splitlines()),
          flush=True)
    del stored

    # a 50,000-row cut: SLSQP below the device solver's threshold, and the
    # pseudo-BMA weights, each against the same call on the CPU
    cut = {name: pl.from_dict(posterior={"beta": post},
                              log_likelihood={"y": np.ascontiguousarray(ll[:, :, :n_cut])})
           for name, ll, post in (("m1", ll1_host, beta), ("m2", ll2_host, beta2_host))}
    del ll1_host, ll2_host
    card = {name: pl.loo(idata, pointwise=True) for name, idata in cut.items()}
    t = time.perf_counter()
    cpu = on_cpu(pl, lambda: {name: pl.loo(idata, pointwise=True) for name, idata in cut.items()})
    print(f"  time  loo() of the two {n_cut}-row cuts on the CPU: {time.perf_counter() - t:.3f} s",
          flush=True)
    for method in ("stacking", "bb-pseudo-bma", "pseudo-bma"):
        on_card = timed_call(f"loo_compare ({n_cut}-row cut, {method})",
                             lambda: pl.loo_compare(card, method=method, seed=7), timings)
        on_host = on_cpu(pl, lambda: pl.loo_compare(cpu, method=method, seed=7))
        d_w = np.abs(on_card["weight"] - on_host["weight"]).max()
        d_e = np.abs(on_card["elpd_loo"] / on_host["elpd_loo"] - 1).max()
        d_se = np.abs(on_card["se"] / on_host["se"] - 1).max()
        check(on_card.index == on_host.index and d_w <= 1e-4 and d_e <= 1e-6 and d_se <= 1e-4,
              f"{method} on the {n_cut}-row cut against the CPU: weights"
              f" {np.round(on_card['weight'], 6).tolist()}, max |d weight| {d_w:.3g} (1e-4),"
              f" max rel d elpd_loo {d_e:.3g} (1e-6), se {d_se:.3g} (1e-4)")
    check(len(em_calls) == n_em + 1, "the 50,000-row stacking ran SLSQP on the host, not the"
          " EM solver")
    del cut, card, cpu

    # (d) loo_score_streaming at full size, held to loo_score on a stored cut
    chunk, n_chunks = _chunks.resolve_chunk(None, n_obs, s, torch.float32,
                                            budget=SCORE_CHUNK_BUDGET)
    print(f"phase 7d: loo_score_streaming at {n_obs} x {s} float32, P = 2 ({n_chunks} chunks of"
          f" {chunk})", flush=True)
    y_host = yw.cpu().numpy()
    m_tail = tail_length(s, reff)
    scores = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the Pareto-k warning; the counts are printed
        for scale in (False, True):
            what = f"loo_score_streaming (P=2, scale={scale})"
            scores[scale] = timed_call(what, lambda: pl.loo_score_streaming(
                ll1, x_fn, x2_fn, y_host, n_obs, s, permutations=2, reff=reff, scale=scale,
                seed=11, dtype="float32"), timings)
            res = scores[scale]
            got = timings[what]["launches"]
            check(not any(got.values()) and res.pointwise.shape == (n_obs,)
                  and np.isfinite(res.pointwise).all(),
                  f"{what}: launches none of A-D ({got}); {n_obs} finite scores, estimate"
                  f" {res.estimates['Estimate']:.6f} (SE {res.estimates['SE']:.3g});"
                  f" {int((res.pareto_k > res.good_k).sum())} rows with k > {res.good_k:.2f}")

        # the stored cut: the same generator calls, chunk by chunk, so its rows
        # are those the streaming run scored
        n_store, n_64 = 65_536, 4_096
        made = {"ll": [], "x": [], "x2": []}
        for c in range(-(-n_store // chunk)):
            idx, _ = _chunks.chunk_indices(c, chunk, n_obs, torch.device("cuda"))
            for name, fn in (("ll", ll1), ("x", x_fn), ("x2", x2_fn)):
                made[name].append(fn(idx).cpu())
        rows = {name: torch.cat(parts)[:n_store].numpy() for name, parts in made.items()}
        del made

        def as_idata(n, dtype):
            cdo = {name: np.ascontiguousarray(a[:n].T).astype(dtype).reshape(chains, draws, n)
                   for name, a in rows.items()}
            return pl.from_dict(posterior={"beta": beta}, log_likelihood={"y": cdo["ll"]},
                                posterior_predictive={"y": cdo["x"], "y2": cdo["x2"]},
                                observed_data={"y": y_host[:n].astype(dtype)},
                                dims={"y": ["obs"], "y2": ["obs"]})

        idata = as_idata(n_store, np.float32)
        kw = dict(x_var="y", x2_var="y2", permutations=2, reff=reff, seed=11, pointwise=True)
        for scale in (False, True):
            stored_score = timed_call(f"loo_score (stored {n_store} rows, scale={scale})",
                                      lambda: pl.loo_score(idata, scale=scale, **kw), timings)
            got = timings[f"loo_score (stored {n_store} rows, scale={scale})"]["launches"]
            a, b = stored_score.pointwise, scores[scale].pointwise[:n_store]
            ka, kb = stored_score.pareto_k.values, scores[scale].pareto_k[:n_store]
            check(not any(got.values()) and np.allclose(a, b, rtol=1e-5, atol=1e-6)
                  and np.allclose(ka, kb, rtol=0, atol=1e-4),
                  f"scale={scale}: loo_score_streaming's first {n_store} rows against loo_score"
                  f" on them stored (rtol 1e-5, atol 1e-6: max |d| {np.abs(a - b).max():.3g},"
                  f" {(a != b).sum()} rows differ at all; k atol 1e-4: max |d k|"
                  f" {np.abs(ka - kb).max():.3g}); launches {got}")
        del idata
        pl.rcParams["device.precision"] = "float64"
        idata64 = as_idata(n_64, np.float64)
        for scale in (False, True):
            card64 = timed_call(f"loo_score float64 ({n_64} rows, scale={scale})",
                                lambda: pl.loo_score(idata64, scale=scale, **kw), timings,
                                main_path=False)
            t = time.perf_counter()
            cpu64 = on_cpu(pl, lambda: pl.loo_score(idata64, scale=scale, **kw))
            cpu_s = time.perf_counter() - t
            d = np.abs(card64.pointwise - cpu64.pointwise).max()
            d_k = np.abs(card64.pareto_k.values - cpu64.pareto_k.values).max()
            check(np.allclose(card64.pointwise, cpu64.pointwise, rtol=1e-12, atol=1e-12)
                  and np.allclose(card64.pareto_k.values, cpu64.pareto_k.values, rtol=1e-12,
                                  atol=1e-12),
                  f"float64 loo_score (scale={scale}) on the card against the CPU ({cpu_s:.2f} s)"
                  f" within 1e-12: max |d| {d:.3g}, max |d k| {d_k:.3g}")
        pl.rcParams["device.precision"] = "float32"
        del idata64, rows

    # where one chunk of loo_score_streaming goes (CUDA events, median of 3)
    idx, _ = _chunks.chunk_indices(0, chunk, n_obs, torch.device("cuda"))
    ll, x, x2 = ll1(idx), x_fn(idx), x2_fn(idx)
    y_dev = yw[idx]
    perms = torch.from_numpy(score_mod.draw_permutations(11, 2, s)).cuda()
    stage = {
        "log_lik_fn": median_ms(lambda: ll1(idx), 3),
        "x_fn": median_ms(lambda: x_fn(idx), 3),
        "x2_fn": median_ms(lambda: x2_fn(idx), 3),
        "psislw_batch (one of 3)": median_ms(lambda: psislw_batch(-ll, m_tail), 3),
        "_crps_chunk (whole)": median_ms(lambda: score_mod._crps_chunk(
            ll, x, x2, y_dev, perms, tail_max=m_tail, scale=False), 3),
    }
    stage["means and the rest"] = stage["_crps_chunk (whole)"] - 3 * stage["psislw_batch (one of 3)"]
    del ll, x, x2
    gen = stage["log_lik_fn"] + stage["x_fn"] + stage["x2_fn"]
    print(f"  time  one chunk of {chunk} rows: "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in stage.items())
          + f"; x {n_chunks} chunks: generators {n_chunks * gen / 1e3:.3f} s, psislw_batch"
          f" {n_chunks * 3 * stage['psislw_batch (one of 3)'] / 1e3:.3f} s, means and the rest"
          f" {n_chunks * stage['means and the rest'] / 1e3:.3f} s", flush=True)

    # (e) loo_lfo at 10,000 time points x 4,000 draws, float64
    n_t, L, n_first = 10_000, 1_000, 1_024
    print(f"phase 7e: loo_lfo at {n_t} x {s} float64, L = {L}", flush=True)
    pl.rcParams["device.precision"] = "float64"
    series = np.ascontiguousarray(ll_host[:, :, :n_t]).astype(np.float64)
    idata_t = pl.from_dict(posterior={"beta": beta}, log_likelihood={"y": series})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the high-k summary; the count is printed
        for M in (1, 4):
            what = f"loo_lfo (L={L}, M={M})"
            res = timed_call(what, lambda: pl.loo_lfo(idata_t, L=L, M=M, pointwise=True), timings)
            got = timings[what]["launches"]
            part = pl.from_dict(posterior={"beta": beta}, log_likelihood={
                "y": np.ascontiguousarray(series[:, :, : L + n_first + M - 1])})
            t = time.perf_counter()
            cpu = on_cpu(pl, lambda: pl.loo_lfo(part, L=L, M=M, pointwise=True))
            cpu_s = time.perf_counter() - t
            a, b = res.lfo_i.values[:n_first], cpu.lfo_i.values
            ka, kb = res.pareto_k[:n_first], cpu.pareto_k
            check(not any(got.values()) and res["n_data_points"] == n_t - M - L + 1
                  and np.allclose(a, b, rtol=1e-12, atol=1e-12, equal_nan=True)
                  and np.allclose(ka, kb, rtol=1e-12, atol=1e-12, equal_nan=True),
                  f"M={M}: {res['n_data_points']} targets, elpd_lfo {res['elpd_lfo']:.3f},"
                  f" {int((res.pareto_k > res.good_k).sum())} with k > {res.good_k:.2f};"
                  f" the first {n_first} against the CPU on the series cut to"
                  f" {L + n_first + M - 1} rows ({cpu_s:.2f} s) within 1e-12: max |d|"
                  f" {np.abs(a - b).max():.3g}, max |d k| {np.nan_to_num(np.abs(ka - kb)).max():.3g};"
                  f" launches {got}")
    pl.rcParams["device.precision"] = "float32"
    del series, idata_t

    launched = {what: t["launches"] for what, t in timings.items()
                if "launches" in t and any(t["launches"].values())}
    print("  count launches of the kernels in phase 7, each public call a window of its own: "
          + ("; ".join(what + ": " + " ".join(f"{name} {n}" for name, n in got.items() if n)
                       for what, got in launched.items()) or "none")
          + f"; the other {sum('launches' in t for t in timings.values()) - len(launched)}"
          " calls launch none of A to D", flush=True)
    print(f"  card  {smi}", flush=True)


def phase_disk(pl, ll_host, model, reff: float, phase5: dict, waic32, smi: str,
               n_rows: int = 250_000, n_cut: int = 262_144, small: int = 31_256) -> None:
    """Phase 8: a log-likelihood on disk (NpyLogLik, loo_from_file, waic_from_file),
    and the streaming readers of the weights at full size."""
    import shutil
    import tempfile
    import warnings

    import numpy as np
    import torch

    from pyloo_tpu_torch.base import ISMethod
    from pyloo_tpu_torch.loo_predictive_metric import _accuracy, _mae
    from pyloo_tpu_torch.ops.psis import tail_length
    from pyloo_tpu_torch.streaming import _accumulate, _chunks
    from pyloo_tpu_torch.streaming.expectations import ELOO_CHUNK_BUDGET

    xw, yw, beta_c = model
    chains, draws = beta_c.shape[0], beta_c.shape[1]
    n_obs, s = xw.shape[0], chains * draws
    gb = n_rows * s * 4 / 1e9
    print(f"phase 8: a log-likelihood on disk ({n_rows} x {s} float32, {gb:.1f} GB) and the"
          f" streaming readers at {n_obs} x {s} ({smi})", flush=True)
    pl.rcParams["device.device"] = "cuda"
    pl.rcParams["device.precision"] = "float32"
    timings: dict = {}
    cuda = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="pyloo_disk_")
    try:
        # (a) the first 250,000 rows of phase 2's matrix, written as .npy
        path = os.path.join(tmp, "log_lik.npy")
        t = time.perf_counter()
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32, shape=(n_rows, s))
        for start in range(0, n_rows, 50_000):
            n = min(50_000, n_rows - start)
            mm[start : start + n] = obs_major(ll_host, n, start).cpu().numpy()
        mm.flush()
        del mm
        print(f"  data  {gb:.1f} GB written with open_memmap in {time.perf_counter() - t:.1f} s",
              flush=True)

        # (b) the default geometry: equal to phase 5b's loo_streaming over the same rows
        chunk, n_chunks = _chunks.resolve_chunk(None, n_rows, s, torch.float32)
        e5b, k5b = phase5["5b"]
        # twice: the second call finds its pinned staging in torch's host cache
        for turn in ("", ", again"):
            what = f"loo_from_file (native, {n_chunks} chunks of {chunk}{turn})"
            res = timed_call(what, lambda: pl.loo_from_file(path, native=True, reff=reff,
                                                            dtype="float32", pointwise=True),
                             timings)
            got = timings[what]["launches"]
            e, k = res.loo_i.values, res.pareto_k.values
            check(got["A"] == n_chunks and got["B"] == got["C"] == got["D"] == 0
                  and np.array_equal(e, e5b, equal_nan=True)
                  and np.array_equal(k, k5b, equal_nan=True),
                  f"{what}: kernel A launched {got['A']} times ({n_chunks} expected); loo_i and"
                  f" k equal phase 5b's loo_streaming over the stored rows"
                  f" ({int((e != e5b).sum())} loo_i and {int((k != k5b).sum())} k differ);"
                  f" {gb / timings[what]['wall_s']:.2f} GB/s from the file")

        # (c) 8 chunks: the read / copy pipeline has chunks to overlap; native
        # prefetcher against the memmap reader
        small, n8 = _chunks.resolve_chunk(small, n_rows, s, torch.float32)
        t = time.perf_counter()
        pinned = [torch.empty((small, s), dtype=torch.float32, pin_memory=True)
                  for _ in range(2)]
        pin_s = time.perf_counter() - t
        del pinned  # into torch's host cache: both readers below find their staging there
        print(f"  time  pinning two staging buffers of {small} x {s} float32: {pin_s:.3f} s",
              flush=True)
        outs = {}
        for native in (True, False):
            what = f"loo_streaming over NpyLogLik(native={native}), {n8} chunks of {small}"
            with pl.NpyLogLik(path, native=native) as src:
                outs[native] = timed_call(what, lambda: pl.loo_streaming(
                    src, n_rows, s, reff=reff, chunk_size=small, dtype="float32",
                    pointwise=True), timings)
                native_ok = src.is_native is native
                reads = src.reads_issued
            got = timings[what]["launches"]
            check(native_ok and reads == (n8 if native else None) and got["A"] == n8,
                  f"{what}: is_native {native_ok and native}, reads_issued {reads} ({n8 if native else None}"
                  f" expected), kernel A {got['A']}; {gb / timings[what]['wall_s']:.2f} GB/s")
        e8, k8 = outs[True].loo_i.values, outs[True].pareto_k.values
        check(np.array_equal(e8, outs[False].loo_i.values, equal_nan=True)
              and np.array_equal(k8, outs[False].pareto_k.values, equal_nan=True)
              and np.allclose(e8, e, rtol=1e-6, atol=1e-6, equal_nan=True)
              and np.allclose(k8, k, rtol=1e-6, atol=1e-6, equal_nan=True),
              f"the two readers give equal results; {n8} chunks against {n_chunks} within rtol/atol"
              f" 1e-6 (max |d loo_i| {np.nanmax(np.abs(e8 - e)):.3g}, {int((e8 != e).sum())} rows"
              f" differ at all)")
        del outs, res

        # one chunk of 31,250 rows: the host read, the copy and the scoring
        staging = torch.empty((small, s), dtype=torch.float32, pin_memory=True)
        pageable = torch.empty((small, s), dtype=torch.float32)
        read_s = {}
        for native, buf in ((True, staging), (False, pageable)):
            with pl.NpyLogLik(path, native=native) as src:
                src._read_into(0, buf)  # the native ring's first read is synchronous
                t = time.perf_counter()
                src._read_into(small, buf)
                read_s[native] = time.perf_counter() - t
        chunk_gb = small * s * 4 / 1e9
        copy_pinned = median_ms(lambda: staging.to(cuda, non_blocking=True), 5)
        copy_pageable = median_ms(lambda: pageable.to(cuda), 5)
        ll = staging.to(cuda)
        valid = torch.ones(small, dtype=torch.bool, device=cuda)
        carry = _accumulate.init_carry(ISMethod.PSIS, False, torch.float32, 0.7, cuda)
        m_tail = tail_length(s, reff)
        score = median_ms(lambda: _accumulate.accumulate_chunk(
            ll, valid, carry, method=ISMethod.PSIS, tail_max=m_tail), 3)
        del ll, staging, pageable
        print(f"  time  one chunk of {small} rows ({chunk_gb:.2f} GB): host read native"
              f" {1e3 * read_s[True]:.1f} ms ({chunk_gb / read_s[True]:.2f} GB/s), memmap"
              f" {1e3 * read_s[False]:.1f} ms ({chunk_gb / read_s[False]:.2f} GB/s); copy pinned"
              f" {copy_pinned:.1f} ms ({chunk_gb / copy_pinned * 1e3:.2f} GB/s), pageable"
              f" {copy_pageable:.1f} ms ({chunk_gb / copy_pageable * 1e3:.2f} GB/s); scoring"
              f" (kernel A, fit, sums) {score:.1f} ms", flush=True)

        # (d) waic_from_file against phase 6's waic of the stored matrix on those rows
        what = "waic_from_file (native)"
        w = timed_call(what, lambda: pl.waic_from_file(path, native=True, dtype="float32",
                                                        pointwise=True), timings)
        ref = np.asarray(waic32.waic_i.values[:n_rows], np.float64)
        want = float(ref.sum())
        check(not any(timings[what]["launches"].values())
              and np.allclose(w.waic_i.values, ref, rtol=1e-5, atol=1e-5)
              and abs(w["elpd_waic"] / want - 1) <= 1e-6,
              f"{what}: waic_i against phase 6's waic on the same rows (rtol/atol 1e-5: max |d|"
              f" {np.abs(w.waic_i.values - ref).max():.3g}); elpd_waic {w['elpd_waic']:.4f} against"
              f" their sum {want:.4f} (rel 1e-6)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (e) the streaming readers at full size: phase 5's model, phase 7's draws
    beta_s = beta_c.reshape(s, -1)  # sample = chain * draws + draw, as loo() stacks them
    zero = xw.new_zeros(())

    def log_lik_fn(idx):
        eta = xw[idx] @ beta_s.T  # (chunk, S), full float32 (no TF32)
        return yw[idx, None] * eta - torch.logaddexp(eta, zero)

    def x_fn(idx):  # posterior-predictive draws, the same whatever the chunk
        return bernoulli_draws(idx, xw[idx] @ beta_s.T, 0)

    y_host = yw.cpu().numpy()
    probs = [0.05, 0.5, 0.95]
    kinds = (("mean", None), ("variance", None), ("quantile", probs))
    chunk, n_chunks = _chunks.resolve_chunk(None, n_obs, s, torch.float32,
                                            budget=ELOO_CHUNK_BUDGET)
    print(f"phase 8b: e_loo_streaming, loo_predictive_metric_streaming and loo_group_streaming"
          f" at {n_obs} x {s} float32 ({n_chunks} chunks of {chunk})", flush=True)
    big = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the Pareto-k warnings; the counts are printed
        for kind, pr in kinds:
            big[kind] = timed_call(f"e_loo_streaming {kind}", lambda: pl.e_loo_streaming(
                log_lik_fn, x_fn, n_obs, s, type=kind, probs=pr, reff=reff, dtype="float32"),
                timings)
        metrics = {m: timed_call(f"loo_predictive_metric_streaming {m}",
                                 lambda: pl.loo_predictive_metric_streaming(
                                     log_lik_fn, x_fn, y_host, n_obs, s, metric=m, r_eff=reff,
                                     dtype="float32"), timings)
                   for m in ("mae", "acc")}
        groups = np.arange(n_obs) % 1_000
        logo = timed_call("loo_group_streaming (1,000 groups)", lambda: pl.loo_group_streaming(
            log_lik_fn, groups, n_obs, s, reff=reff, dtype="float32", pointwise=True), timings)
    q = big["quantile"].value.values
    check(all(np.isfinite(r.value.values).all() for r in big.values())
          and bool((np.diff(q, axis=1) >= 0).all())
          and abs(metrics["mae"]["estimate"] - _mae(y_host, big["mean"].value.values.astype(np.float64))["estimate"]) <= 1e-12
          and abs(metrics["acc"]["estimate"] - _accuracy(y_host, big["mean"].value.values.astype(np.float64))["estimate"]) <= 1e-12
          and logo["n_groups"] == 1_000 and np.isfinite(logo.logo_i.values).all(),
          f"finite values, quantiles ordered in the probabilities; mae"
          f" {metrics['mae']['estimate']:.6f} and acc {metrics['acc']['estimate']:.6f} are the"
          f" metrics of e_loo_streaming's mean; elpd_logo {logo['elpd_logo']:.2f} over 1,000"
          f" groups; k > 0.7 on {int((big['mean'].pareto_k.values > 0.7).sum())} rows (mean)")

    # each held to its stored-matrix form on the first rows, made by the same
    # generator calls at the stream's chunking (so the rows are those scored)
    parts_ll, parts_x = [], []
    for c in range(-(-n_cut // chunk)):
        idx, _ = _chunks.chunk_indices(c, chunk, n_obs, cuda)
        parts_ll.append(log_lik_fn(idx).cpu())
        parts_x.append(x_fn(idx).cpu())
    ll_cut = torch.cat(parts_ll)[:n_cut].numpy()
    x_cut = torch.cat(parts_x)[:n_cut].numpy()
    del parts_ll, parts_x
    ll_da = pl.DataArray(ll_cut, ("obs", "__sample__"))
    lr_da = pl.DataArray(-ll_cut, ("obs", "__sample__"))
    x_da = pl.DataArray(x_cut, ("obs", "__sample__"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lw, _ = pl.psislw(-ll_da, reff=reff)
        stored = {kind: pl.e_loo(x_da, log_weights=lw, log_ratios=lr_da, type=kind, probs=pr)
                  for kind, pr in kinds}
        del lw
        tol = {"mean": (1e-4, 1e-7), "variance": (1e-3, 1e-6), "quantile": (1e-4, 1e-7)}
        for kind, _ in kinds:
            a, b = big[kind].value.values[:n_cut], stored[kind].value.values
            ka, kb = big[kind].pareto_k.values[:n_cut], stored[kind].pareto_k.values
            rtol, atol = tol[kind]
            check(np.allclose(a, b, rtol=rtol, atol=atol) and np.allclose(ka, kb, rtol=0, atol=2e-3),
                  f"e_loo_streaming {kind}: its first {n_cut} rows against e_loo on them stored"
                  f" (rtol {rtol:g}, atol {atol:g}: max |d| {np.abs(a - b).max():.3g},"
                  f" {int((a != b).sum())} values differ at all; k atol 2e-3: max |d k|"
                  f" {np.nanmax(np.abs(ka - kb)):.3g})")
        y_cut = y_host[:n_cut].astype(np.float64)
        mean_cut = stored["mean"].value.values.astype(np.float64)
        ll_gen = torch.from_numpy(ll_cut).to(cuda)
        x_gen = torch.from_numpy(x_cut).to(cuda)
        for m, scorer in (("mae", _mae), ("acc", _accuracy)):
            a = pl.loo_predictive_metric_streaming(lambda idx: ll_gen[idx], lambda idx: x_gen[idx],
                                                   y_cut, n_cut, s, metric=m, r_eff=reff,
                                                   chunk_size=chunk, dtype="float32")
            b = scorer(y_cut, mean_cut)
            check(abs(a["estimate"] - b["estimate"]) <= 1e-5 and abs(a["se"] - b["se"]) <= 1e-5,
                  f"loo_predictive_metric_streaming {m} over the stored {n_cut} rows against"
                  f" loo_predictive_metric's arithmetic on e_loo stored: {a['estimate']:.6f} and"
                  f" {b['estimate']:.6f} (atol 1e-5)")
        # the stream's group sums are float64 whatever the chunks' dtype: the
        # stored form in float64 sums the same float32 values in float64
        idata = pl.from_dict(posterior={"beta": np.zeros((1, s))},
                             log_likelihood={"y": np.ascontiguousarray(ll_cut.T)[None]})
        a = pl.loo_group_streaming(lambda idx: ll_gen[idx], groups[:n_cut], n_cut, s, reff=reff,
                                   chunk_size=chunk, dtype="float32", pointwise=True)
        pl.rcParams["device.precision"] = "float64"
        b = pl.loo_group(idata, groups[:n_cut], reff=reff, pointwise=True)
        pl.rcParams["device.precision"] = "float32"
        check(np.allclose(a.logo_i.values, b.logo_i.values, rtol=1e-10, atol=1e-10)
              and np.allclose(a.pareto_k, b.pareto_k, rtol=0, atol=1e-8),
              f"loo_group_streaming over the stored {n_cut} rows against loo_group on them in"
              f" float64 (both sum the float32 rows in float64): logo_i rtol/atol 1e-10 (max"
              f" |d| {np.abs(a.logo_i.values - b.logo_i.values).max():.3g}), k atol 1e-8 (max"
              f" |d k| {np.nanmax(np.abs(a.pareto_k - b.pareto_k)):.3g})")
    del ll_gen, x_gen, idata, ll_cut, x_cut, big, stored
    launched = {what: t["launches"] for what, t in timings.items() if any(t["launches"].values())}
    print("  count launches of the kernels in phase 8, each public call a window of its own: "
          + "; ".join(what + ": " + " ".join(f"{name} {n}" for name, n in got.items() if n)
                      for what, got in launched.items())
          + f"; the other {len(timings) - len(launched)} calls launch none of A to D", flush=True)
    print(f"  card  {smi}", flush=True)


def phase_subsample(pl, ll_host, beta, model, reff: float, res32, phase5: dict, smi: str,
                    n_rows: int = 250_000, m: int = 4_000) -> None:
    """Phase 9: subsampled LOO and LOO for an approximate posterior."""
    import warnings

    import numpy as np
    import torch

    from pyloo_tpu_torch.estimators import subsample_indices
    from pyloo_tpu_torch.streaming import _chunks

    xw, yw, beta_c = model
    chains, draws = beta_c.shape[0], beta_c.shape[1]
    n_obs, s = xw.shape[0], chains * draws
    print(f"phase 9: subsampled LOO and LOO for an approximate posterior at {n_obs} x {s}"
          f" float32 ({smi})", flush=True)
    pl.rcParams["device.device"] = "cuda"
    pl.rcParams["device.precision"] = "float32"
    timings: dict = {}
    beta_s = beta_c.reshape(s, -1)
    zero = xw.new_zeros(())

    def log_lik_fn(idx):
        eta = xw[idx] @ beta_s.T  # (chunk, S), full float32 (no TF32)
        return yw[idx, None] * eta - torch.logaddexp(eta, zero)

    seed = 17
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # (a) loo_subsample_streaming: the sampled rows are those the host draws
        for estimator in ("diff_srs", "hh_pps"):
            what = f"loo_subsample_streaming ({estimator}, {m} of {n_obs})"
            res = timed_call(what, lambda: pl.loo_subsample_streaming(
                log_lik_fn, n_obs, s, m, estimator=estimator, reff=reff, seed=seed,
                dtype="float32"), timings)
            approx = res.estimates.stream["elpd_loo_approximation"]
            want = subsample_indices(estimator, approx, m, rng=np.random.default_rng(seed))
            got_idx = res.estimates.indices
            z = (res["elpd_loo"] - phase5["elpd_loo"]) / res["subsampling_SE"]
            check(np.array_equal(got_idx.idx, want.idx) and np.array_equal(got_idx.m_i, want.m_i)
                  and abs(z) <= 4.0 and not any(timings[what]["launches"].values()),
                  f"{what}: the {len(got_idx.idx)} sampled rows are subsample_indices' on the host;"
                  f" elpd_loo {res['elpd_loo']:.2f} (subsampling SE {res['subsampling_SE']:.2f})"
                  f" is {z:+.2f} SE from phase 5's {phase5['elpd_loo']:.2f} (4 allowed); launches"
                  f" {timings[what]['launches']}")

        # (b) loo_subsample and update_subsample on the stored first rows
        ll_cut = np.ascontiguousarray(ll_host[:, :, :n_rows])
        idata = pl.from_dict(posterior={"beta": beta}, log_likelihood={"y": ll_cut})
        full = float(np.sum(res32.loo_i.values[:n_rows], dtype=np.float64))
        loo_i32 = res32.loo_i.values[:n_rows]
        sub = None
        for size in (m, 2 * m):
            what = f"loo_subsample ({size} of the stored {n_rows} rows)" if sub is None else \
                f"update_subsample ({m} -> {size})"
            np.random.seed(seed + size)
            if sub is None:
                sub = timed_call(what, lambda: pl.loo_subsample(
                    idata, observations=size, seed=seed, pointwise=True), timings)
            else:
                sub = timed_call(what, lambda: pl.update_subsample(sub, observations=size),
                                 timings)
            idx = sub.estimates.indices.idx
            e = sub.loo_i.values[idx]
            z = (sub["elpd_loo"] - full) / sub["subsampling_SE"]
            got = timings[what]["launches"]
            check(len(idx) == size and got["B"] == 1 and got["A"] == got["C"] == got["D"] == 0
                  and np.allclose(e, loo_i32[idx], rtol=1e-4, atol=1e-4) and abs(z) <= 4.0,
                  f"{what}: kernel B {got['B']} (the exact float32 scorer on the sampled rows);"
                  f" their loo_i against phase 2's loo() (rtol/atol 1e-4: max |d|"
                  f" {np.abs(e - loo_i32[idx]).max():.3g}); elpd_loo {sub['elpd_loo']:.2f}"
                  f" (subsampling SE {sub['subsampling_SE']:.2f}) is {z:+.2f} SE from the"
                  f" full {full:.2f}")
        print("  report\n" + "\n".join("    " + line for line in str(sub).splitlines()),
              flush=True)
        del sub

        # (c) loo_approximate_posterior_streaming: log_p, log_q two normal
        # densities of the draws of one coefficient
        b0 = beta_s[:, 0].double().cpu().numpy()
        rng = np.random.default_rng(7)
        mu, sd = b0.mean(), b0.std()
        mu_q, sd_q = mu + 0.2 * sd * rng.standard_normal(), sd * (1.0 + 0.3 * rng.random())

        def normal_logpdf(x, loc, scale):
            return -0.5 * ((x - loc) / scale) ** 2 - np.log(scale) - 0.5 * np.log(2 * np.pi)

        log_p, log_q = normal_logpdf(b0, mu, sd), normal_logpdf(b0, mu_q, sd_q)
        chunk, n_chunks = _chunks.resolve_chunk(None, n_obs, s, torch.float32)
        what = f"loo_approximate_posterior_streaming ({n_obs} x {s})"
        ap = timed_call(what, lambda: pl.loo_approximate_posterior_streaming(
            log_lik_fn, log_p, log_q, n_obs, s, reff=reff, seed=seed, dtype="float32",
            pointwise=True), timings)
        got = timings[what]["launches"]
        check(got["A"] == n_chunks and got["B"] == got["C"] == got["D"] == 0
              and hasattr(ap, "approximate_posterior") and np.isfinite(ap.loo_i.values).all(),
              f"{what}: kernel A launched {got['A']} times ({n_chunks} chunks); elpd_loo"
              f" {ap['elpd_loo']:.2f}, p_loo {ap['p_loo']:.2f}")

        # the stored form on the first rows: the same resample, the exact scorer.
        # The made rows differ from the stored ones in the last bits, so k is held
        # to phase 3's float32 envelope
        what = f"loo_approximate_posterior (stored {n_rows} rows)"
        stored = timed_call(what, lambda: pl.loo_approximate_posterior(
            idata, log_p, log_q, reff=reff, seed=seed, pointwise=True), timings)
        got = timings[what]["launches"]
        a, b = ap.loo_i.values[:n_rows], stored.loo_i.values
        ka, kb = ap.pareto_k.values[:n_rows], stored.pareto_k.values
        close_k = np.abs(ka - kb) <= 2e-3
        check(got["B"] >= 1 and got["A"] == 0 and np.allclose(a, b, rtol=1e-4, atol=1e-4)
              and close_k.mean() >= 0.9999,
              f"{what}: kernel B {got['B']}; loo_i of the stream's first {n_rows} rows against"
              f" it (rtol/atol 1e-4: max |d| {np.abs(a - b).max():.3g}); k within 2e-3 on"
              f" {int(close_k.sum())} rows (all but 1 in 10,000 required; max |d k|"
              f" {np.nanmax(np.abs(ka - kb)):.3g})")
        print("  report\n" + "\n".join("    " + line for line in str(stored).splitlines()),
              flush=True)
    del idata, ll_cut, ap, stored
    launched = {what: t["launches"] for what, t in timings.items() if any(t["launches"].values())}
    print("  count launches of the kernels in phase 9, each public call a window of its own: "
          + "; ".join(what + ": " + " ".join(f"{name} {n}" for name, n in got.items() if n)
                      for what, got in launched.items())
          + f"; the other {len(timings) - len(launched)} calls launch none of A to D", flush=True)
    print(f"  card  {smi}", flush=True)


def poisson_overdispersed(pl, n: int = 600, p: int = 10, seed: int = 3):
    """Phase 10b's model: a Poisson regression with an intercept and 9 normal
    covariates on overdispersed counts (a gamma-Poisson mixture of shape
    0.25 around exp(X beta), made from ``seed``), under N(0, 2.5^2) priors.
    The counts the Poisson cannot explain give ~80 observations k > 0.7.
    Returns the model and its posterior mode (Newton's method on the host)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, p - 1))])
    beta = np.concatenate([[3.0], rng.normal(0.0, 0.5, size=p - 1)])
    y = rng.poisson(np.exp(X @ beta) * rng.gamma(0.25, 1 / 0.25, size=n)).astype(np.float64)

    def log_lik(params, data):
        eta = data["X"] @ params["beta"]
        return data["y"] * eta - torch.exp(eta) - torch.lgamma(data["y"] + 1.0)

    def logp(params, data):
        return torch.sum(-0.5 * (params["beta"] / 2.5) ** 2) + torch.sum(log_lik(params, data))

    b = np.zeros(p)
    b[0] = np.log(y.mean())
    for _ in range(50):
        mu = np.exp(X @ b)
        hess = X.T @ (mu[:, None] * X) + np.eye(p) / 2.5**2
        b = b + np.linalg.solve(hess, X.T @ (y - mu) - b / 2.5**2)
    model = pl.Model("poisson_overdispersed", {"X": X, "y": y}, {"beta": (p,)}, logp, log_lik,
                     obs_keys=("X", "y"))
    return model, b


def laplace_draws(pl, model, start, seed: int, chains: int = 4, draws: int = 1000):
    """(chains, draws, D) independent draws from the Laplace approximation of
    ``model``'s posterior: the mode by 20 Newton steps from ``start`` and the
    covariance the inverse negative Hessian, both by ``torch.func`` on the
    card.  For the phases that need posterior draws but not a sampler."""
    import numpy as np
    import torch

    device = pl.rcParams["device.device"]
    data = model.tensor_data(device)

    def logp(q):
        return model.logp(model.unravel(q), data)

    q = torch.tensor(np.asarray(start, dtype=np.float64), device=device)
    for _ in range(20):
        q = q - torch.linalg.solve(torch.func.hessian(logp)(q), torch.func.grad(logp)(q))
    chol = torch.linalg.cholesky(torch.linalg.inv(-torch.func.hessian(logp)(q)))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    z = torch.randn((chains * draws, q.numel()), generator=gen, dtype=q.dtype, device=device)
    return (q + z @ chol.T).reshape(chains, draws, -1).cpu().numpy()


def phase_refits(pl, smi: str) -> None:
    """Phase 10: model wrappers, moment matching and exact refits, float64."""
    import warnings

    import numpy as np
    import torch

    from pyloo_tpu_torch.models import batched_refit, hmc
    from pyloo_tpu_torch.models.wrapper import _EVAL_BUDGET_BYTES, idata_from_flat_draws
    from pyloo_tpu_torch.ops.ess import rhat

    kfold_mod, reloo_mod = sys.modules["pyloo_tpu_torch.loo_kfold"], sys.modules["pyloo_tpu_torch.reloo"]
    print(f"phase 10: model wrappers, moment matching and exact refits, float64 ({smi})",
          flush=True)
    pl.rcParams["device.device"] = "cuda"
    pl.rcParams["device.precision"] = "float64"
    timings: dict = {}

    # the HMC step loop runs under sync debug mode "error": any read of a
    # device value on the host (.item(), a branch on a tensor, a blocking
    # copy) raises; the batched fold refits are recorded
    real_run, real_batched = hmc._run_chains, batched_refit.kfold_refit_batched
    steps, batched_calls = [], []

    def strict_run(*args, **kwargs):
        steps.append(args[3] + args[4])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_run(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def recorded_batched(model, train_idx, val_idx, **kwargs):
        batched_calls.append((train_idx.shape[0], train_idx.shape[1], val_idx.shape[1],
                              kwargs.get("chains", 4)))
        return real_batched(model, train_idx, val_idx, **kwargs)

    hmc._run_chains = batched_refit._run_chains = strict_run
    kfold_mod.kfold_refit_batched = reloo_mod.kfold_refit_batched = recorded_batched
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            # (a) the roaches fit and moment matching
            roaches = pl.models.roaches_model()
            # 500 + 500, not 1,000 + 1,000, to keep the script within its time
            # limit on the slower hosts
            what = "fit(roaches_model(), 4 chains x 500 + 500 draws, 32 leapfrog steps)"
            idata = timed_call(what, lambda: pl.models.fit(roaches, draws=500, tune=500,
                                                           chains=4, seed=1), timings)
            t = timings[what]
            flat = idata.sample_stats["_flat_draws"].values
            t["steps"], t["ms_per_step"] = steps[-1], 1e3 * t["wall_s"] / steps[-1]
            t["accept"] = float(idata.sample_stats["accept_rate"].values.mean())
            t["rhat"] = max(rhat(flat[:, :, j]) for j in range(flat.shape[2]))
            check(t["rhat"] < 1.05 and np.isfinite(flat).all(),
                  f"{what}: {t['steps']} steps of 4 chains with no host read (sync debug mode"
                  f" 'error'), {t['ms_per_step']:.3f} ms a step, acceptance {t['accept']:.3f},"
                  f" max split-R-hat {t['rhat']:.4f} (< 1.05)")
            res = timed_call("loo(roaches fit)", lambda: pl.loo(idata, pointwise=True), timings)
            n_bad = int(np.sum(res.pareto_k.values > 0.7))
            print(f"  roaches: elpd_loo {res['elpd_loo']:.4f}, p_loo {res['p_loo']:.3f},"
                  f" {n_bad} of 262 observations k > 0.7", flush=True)
            wrapper = pl.JAXModelWrapper(roaches, idata)
            mm = {}
            for batched in (True, False):
                what = f"loo(moment_match=True, split=True, device_batched={batched})"
                mm[batched] = timed_call(what, lambda: pl.loo(
                    idata, pointwise=True, moment_match=True, wrapper=wrapper, split=True,
                    device_batched=batched), timings)
            d_loo = float(np.abs(mm[False].loo_i.values - mm[True].loo_i.values).max())
            d_k = float(np.abs(mm[False].pareto_k.values - mm[True].pareto_k.values).max())
            left = [int(np.sum(r.pareto_k.values > 0.7)) for r in (mm[True], mm[False])]
            check(d_loo <= 1e-10 and d_k <= 1e-10 and max(left) < n_bad,
                  f"roaches moment matching: the device-batched path against the host loop,"
                  f" max |d loo_i| {d_loo:.3g}, max |d k| {d_k:.3g} (1e-10); k > 0.7 {n_bad} ->"
                  f" {left[0]} (host loop {left[1]}); elpd_loo {mm[True]['elpd_loo']:.4f} (host"
                  f" loop {mm[False]['elpd_loo']:.4f}); {mm[True].moment_match_passes} batched"
                  f" passes")
            # the batched call once more with its lanes split over the mesh
            mesh = smoke_mesh()
            what = f"loo(moment_match=True, split=True, device_batched=True) over {mesh}"
            with default_mesh_of(mesh):
                meshed = timed_call(what, lambda: pl.loo(
                    idata, pointwise=True, moment_match=True, wrapper=wrapper, split=True,
                    device_batched=True), timings)
            d_loo = float(np.abs(meshed.loo_i.values - mm[True].loo_i.values).max())
            d_k = float(np.abs(meshed.pareto_k.values - mm[True].pareto_k.values).max())
            check(d_loo <= 1e-10 and d_k <= 1e-10,
                  f"10a (phase 13's mesh): the batched moment matching with its lanes split"
                  f" over {mesh.size} shards against one device, max |d loo_i| {d_loo:.3g},"
                  f" max |d k| {d_k:.3g} (1e-10); {meshed.moment_match_passes} passes"
                  f" ({timings[what]['wall_s']:.3f} s against"
                  f" {timings['loo(moment_match=True, split=True, device_batched=True)']['wall_s']:.3f} s)")

            # (b) many bad observations at once: the greedy loops alone
            # (split=False: the split step is a host loop over the observations
            # on both paths), on draws from the model's Laplace approximation
            # (the HMC sampler mixes slowly at this posterior's scale)
            pm, mode = poisson_overdispersed(pl)
            idata_b = idata_from_flat_draws(pm, laplace_draws(pl, pm, mode, seed=2))
            res_b = timed_call("loo(poisson_overdispersed, 4 x 1,000 Laplace draws)",
                               lambda: pl.loo(idata_b, pointwise=True), timings)
            k_b = res_b.pareto_k.values
            bad_b = np.nonzero(k_b > 0.7)[0]
            s_b = 4 * 1000
            full_gb = len(bad_b) * s_b * pm.n_obs * 8 / 1e9
            check(len(bad_b) >= 64, f"poisson_overdispersed ({pm.n_obs} observations, P ="
                  f" {pm.flat_dim}): {len(bad_b)} observations k > 0.7 (64 required)")
            wrapper_b = pl.JAXModelWrapper(pm, idata_b)
            what_b = f"loo_moment_match(poisson, its {len(bad_b)} observations, device_batched=True)"
            mm_bb = timed_call(what_b, lambda: pl.loo_moment_match(
                wrapper_b, res_b, split=False, device_batched=True), timings)
            # the host loop on 8 of them: the others' k is set below the
            # threshold in its input, so it leaves them alone
            sub = bad_b[:8]
            res_sub = res_b.copy()
            k_sub = res_sub.pareto_k.values
            k_sub[np.setdiff1d(bad_b, sub)] = 0.0
            what_h = f"loo_moment_match(poisson, {len(sub)} of them, device_batched=False)"
            mm_bh = timed_call(what_h, lambda: pl.loo_moment_match(
                wrapper_b, res_sub, split=False, device_batched=False), timings)
            peak = timings[what_b]["peak_gb"]
            budget = 2 * _EVAL_BUDGET_BYTES / 1e9
            check(peak <= budget,
                  f"the batched path's peak device memory {peak:.3f} GB within {budget:.2f} GB"
                  f" (twice the model evaluation budget); the full-vector log-likelihood of"
                  f" {len(bad_b)} lanes x {s_b} draws x {pm.n_obs} observations alone is"
                  f" {full_gb:.2f} GB")
            # the lanes of a group evaluate log p in batches of other shapes than
            # the host loop's, so the paths are not bitwise alike here; 1e-3 is
            # far inside loo_i's Monte Carlo error
            d_loo = float(np.abs(mm_bb.loo_i.values[sub] - mm_bh.loo_i.values[sub]).max())
            d_k = float(np.abs(mm_bb.pareto_k.values[sub] - mm_bh.pareto_k.values[sub]).max())
            per_b = timings[what_b]["wall_s"] / len(bad_b)
            per_h = timings[what_h]["wall_s"] / len(sub)
            check(d_loo <= 1e-3 and d_k <= 1e-3 and np.sum(mm_bb.pareto_k.values > 0.7) < len(bad_b),
                  f"poisson moment matching: {mm_bb.moment_match_passes} batched passes,"
                  f" {per_b:.3f} s an observation batched against {per_h:.3f} s on the host"
                  f" loop ({per_h / per_b:.1f}x); on the host loop's {len(sub)} observations max"
                  f" |d loo_i| {d_loo:.3g}, max |d k| {d_k:.3g} (1e-3); k > 0.7"
                  f" {len(bad_b)} -> {int(np.sum(mm_bb.pareto_k.values > 0.7))}")

            # (c) exact refits, each a batched HMC run from the default start
            wells = pl.models.wells_model()
            refit_kw = dict(draws=300, tune=300, chains=4, num_leapfrog=8)
            wfit = idata_from_flat_draws(wells, laplace_draws(pl, wells, np.zeros(3), seed=3))
            wloo = timed_call("loo(wells, 4 x 1,000 Laplace draws)",
                              lambda: pl.loo(wfit, pointwise=True), timings)
            ww = pl.JAXModelWrapper(wells, wfit, sample_kwargs=dict(refit_kw, seed=4))
            what = "loo_kfold(wells, K=10)"
            kf = timed_call(what, lambda: pl.loo_kfold(ww, K=10, random_seed=0, pointwise=True),
                            timings)
            d = kf["elpd_kfold"] - wloo["elpd_loo"]
            check(batched_calls[-1:] == [(10, 2718, 302, 4)] and np.isfinite(kf.kfold_i.values).all()
                  and abs(d) < 4 * wloo["se"] / 10,
                  f"{what}: one batched run of 10 folds x 4 chains (40 chains) of 2,718 training"
                  f" rows; {timings[what]['wall_s'] / steps[-1] * 1e3:.3f} ms a step;"
                  f" held-out elpd_kfold {kf['elpd_kfold']:.3f} against PSIS elpd_loo"
                  f" {wloo['elpd_loo']:.3f} (d {d:+.3f}, within 0.4 of its se {wloo['se']:.3f})")
            rw = pl.JAXModelWrapper(roaches, idata, sample_kwargs=dict(refit_kw, seed=5))
            what = f"reloo(roaches, its {n_bad} observations k > 0.7)"
            rr = timed_call(what, lambda: pl.reloo(rw, loo_orig=res, verbose=False), timings)
            bad = res.pareto_k.values > 0.7
            check(batched_calls[-1:] == [(n_bad, 261, 1, 4)] and (rr.pareto_k.values[bad] == 0).all()
                  and np.isfinite(rr.loo_i.values).all(),
                  f"{what}: one batched run of {n_bad} leave-one-out refits x 4 chains;"
                  f" {timings[what]['wall_s'] / steps[-1] * 1e3:.3f} ms a step; elpd_loo"
                  f" {rr['elpd_loo']:.3f} (PSIS {res['elpd_loo']:.3f}, moment matched"
                  f" {mm[True]['elpd_loo']:.3f}); the refitted observations' sum"
                  f" {rr.loo_i.values[bad].sum():.3f} (PSIS {res.loo_i.values[bad].sum():.3f},"
                  f" moment matched {mm[True].loo_i.values[bad].sum():.3f})")
    finally:
        hmc._run_chains = batched_refit._run_chains = real_run
        kfold_mod.kfold_refit_batched = reloo_mod.kfold_refit_batched = real_batched
    launched = {what: t["launches"] for what, t in timings.items() if any(t["launches"].values())}
    check(not launched, "phase 10 runs in float64 and launches none of kernels A to D in any of"
          f" its {len(timings)} windows (expected: no float32 scorer runs here)"
          + (f"; launched: {launched}" if launched else ""))
    print(f"  card  {smi}", flush=True)


def phase_fits(pl, smi: str) -> None:
    """Phase 11: the NUTS and ChEES samplers, the Laplace and ADVI fits and
    non-factorised LOO, float64."""
    import warnings

    import numpy as np
    import torch

    from pyloo_tpu_torch.models import chees, hmc, nuts
    from pyloo_tpu_torch.models.wrapper import idata_from_flat_draws
    from pyloo_tpu_torch.ops.ess import rhat

    print(f"phase 11: NUTS, ChEES, Laplace, ADVI and loo_nonfactor, float64 ({smi})", flush=True)
    pl.rcParams["device.device"] = "cuda"
    pl.rcParams["device.precision"] = "float64"
    timings: dict = {}

    # each sampler's step loop runs under sync debug mode "error"; its one
    # host read a doubling (NUTS) or an iteration (ChEES) goes through
    # hmc._host_value, which is counted and let through; the gradient
    # evaluations are counted on the host
    real = {"nuts": nuts._run_chains, "chees": chees._run_chains, "read": hmc._host_value}
    runs, reads = {}, [0]
    # "default" for the short runs under torch.profiler, which counts, not checks
    mode = ["error"]

    def strict(name):
        def run(value_and_grad, *args, **kwargs):
            calls = [0]

            def counted(q):
                calls[0] += 1
                return value_and_grad(q)

            reads[0] = 0
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode(mode[0])
            try:
                out = real[name](counted, *args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            runs[name] = {"out": out, "grad_calls": calls[0], "steps": args[2] + args[3],
                          "reads": reads[0]}
            return out

        return run

    def counted_read(x):
        reads[0] += 1
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real["read"](x)
        finally:
            torch.cuda.set_sync_debug_mode(mode[0])

    def where_time_goes(name: str, sample, chains: int, wall_per_grad_us: float) -> None:
        """torch.profiler over one vmapped ``grad_and_value`` of the chains
        and over 20 + 20 iterations of ``sample``: the card's operations a
        gradient call and outside it, and the card's busy share (the short
        run's device time a gradient call over the full run's wall a
        gradient call, which ran without the profiler)."""
        vg = hmc._value_and_grad(lambda q: -eight.logp_flat(q))
        q = torch.zeros((chains, eight.flat_dim), dtype=torch.float64, device="cuda")
        vg(q)
        one = profiled(lambda: vg(q))
        mode[0] = "default"
        try:
            run = profiled(lambda: sample(eight.logp_flat, np.zeros(eight.flat_dim),
                                          num_warmup=20, num_samples=20, num_chains=chains,
                                          seed=1))
        finally:
            mode[0] = "error"
        grads, iterations = runs[name]["grad_calls"], 40
        grad_ops, ops = one["kernels"] + one["copies"], run["kernels"] + run["copies"]
        if not ops:
            print(f"  prof  {name}: torch.profiler saw no operation on the card; launch calls"
                  f" {one['launch_calls']} a gradient call,"
                  f" {run['launch_calls'] / iterations:.1f} an iteration", flush=True)
            return
        rest = ops - grads * grad_ops
        busy_us = run["device_us"] / grads
        print(f"  prof  {name} (torch.profiler): one vmapped grad_and_value of {chains} chains"
              f" {grad_ops} operations on the card ({one['kernels']} kernels,"
              f" {one['launch_calls']} launch calls, {one['device_us']:.1f} us of device time);"
              f" 20 + 20 iterations: {grads} gradient calls, {runs[name]['reads']} host reads,"
              f" {ops / iterations:.1f} operations and {run['launch_calls'] / iterations:.1f}"
              f" launch calls an iteration; outside the gradient calls"
              f" {rest / iterations:.1f} operations an iteration, {rest / grads:.1f} a gradient"
              f" call; {busy_us:.1f} us of device time a gradient call against"
              f" {wall_per_grad_us:.1f} us of wall in the full run: the card busy"
              f" {100 * busy_us / wall_per_grad_us:.1f}%", flush=True)

    nuts._run_chains, chees._run_chains = strict("nuts"), strict("chees")
    hmc._host_value = counted_read
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eight = pl.models.eight_schools_noncentered()
            # (a) NUTS, 4 chains x (500 + 500), max_depth 8
            what = "fit(eight_schools_noncentered(), algorithm='nuts', 4 chains x 500 + 500)"
            idata = timed_call(what, lambda: pl.models.fit(eight, draws=500, tune=500, chains=4,
                                                           seed=1, algorithm="nuts"), timings)
            r, t = runs["nuts"], timings[what]
            _, acc, depth, div, doublings = r["out"]
            depth = depth.cpu().numpy()
            t.update(steps=r["steps"], ms_per_step=1e3 * t["wall_s"] / r["steps"],
                     ms_per_draw=1e3 * t["wall_s"] / (4 * r["steps"]),
                     mean_depth=float(depth.mean()), leaves_per_draw=float((2.0**depth - 1).mean()),
                     grad_calls_per_step=(r["grad_calls"] - 1) / r["steps"],
                     divergences=int(div.sum()), accept=float(acc.mean()),
                     doublings=doublings, reads=r["reads"],
                     rhat=max(rhat(idata.posterior[v].values) for v in ("mu", "tau")))
            check(t["rhat"] < 1.05 and t["reads"] == doublings
                  and np.isfinite(idata.sample_stats["_flat_draws"].values).all(),
                  f"{what}: {t['ms_per_step']:.3f} ms a transition of the 4 chains"
                  f" ({t['ms_per_draw']:.3f} ms a draw); mean tree depth {t['mean_depth']:.3f},"
                  f" {t['leaves_per_draw']:.2f} leaves a chain's draw,"
                  f" {t['grad_calls_per_step']:.2f} gradient calls a transition (lockstep);"
                  f" {t['divergences']} divergences after warmup; accept_stat {t['accept']:.3f};"
                  f" host reads {t['reads']} = doublings {doublings}; max split-R-hat of mu,"
                  f" tau {t['rhat']:.4f} (< 1.05)")
            where_time_goes("nuts", pl.models.sample_nuts, 4, 1e6 * t["wall_s"] / r["grad_calls"])

            # (b) ChEES, 16 chains x (500 + 500)
            what = "fit(eight_schools_noncentered(), algorithm='chees', 16 chains x 500 + 500)"
            idata = timed_call(what, lambda: pl.models.fit(eight, draws=500, tune=500,
                                                           seed=1, algorithm="chees"), timings)
            r, t = runs["chees"], timings[what]
            _, acc, steps = r["out"]
            t.update(steps=r["steps"], ms_per_step=1e3 * t["wall_s"] / r["steps"],
                     leapfrog_warmup=float(np.mean(steps[:500])),
                     leapfrog_sampling=float(np.mean(steps[500:])), leapfrog_max=max(steps),
                     grad_calls=r["grad_calls"], accept=float(acc.mean()), reads=r["reads"],
                     rhat=max(rhat(idata.posterior[v].values) for v in ("mu", "tau")))
            check(t["rhat"] < 1.05 and t["reads"] == r["steps"] == len(steps)
                  and t["grad_calls"] == sum(steps) + 1
                  and idata.posterior["mu"].values.shape == (16, 500),
                  f"{what}: {t['ms_per_step']:.3f} ms an iteration of the 16 chains; leapfrog"
                  f" steps an iteration {t['leapfrog_warmup']:.2f} in warmup,"
                  f" {t['leapfrog_sampling']:.2f} after (max {t['leapfrog_max']}); accept"
                  f" {t['accept']:.3f}; host reads {t['reads']} = iterations {r['steps']};"
                  f" max split-R-hat of mu, tau {t['rhat']:.4f} (< 1.05)")
            where_time_goes("chees", chees.sample_chees, 16, 1e6 * t["wall_s"] / r["grad_calls"])
    finally:
        nuts._run_chains, chees._run_chains = real["nuts"], real["chees"]
        hmc._host_value = real["read"]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # (c) Laplace and ADVI on wells, each into loo_approximate_posterior,
        # held to the PSIS elpd_loo of phase 10c's Laplace draws (the same
        # draws): Laplace within 1.0; ADVI within 5.0, since at 2,000 Adam
        # steps its fits are not converged and the importance correction
        # keeps a bias of a few nats (pyloo_tpu's own on the CPU, seeds 0-2:
        # mean-field -1969.1 to -1969.7, full-rank -1972.1 to -1972.9)
        wells = pl.models.wells_model()
        wfit = idata_from_flat_draws(wells, laplace_draws(pl, wells, np.zeros(3), seed=3))
        ref = pl.loo(wfit)["elpd_loo"]
        approx = {"Laplace": (pl.Laplace(wells), 1.0),
                  "ADVI meanfield": (pl.ADVI(wells, "meanfield"), 5.0),
                  "ADVI fullrank": (pl.ADVI(wells, "fullrank"), 5.0)}
        for name, (fitter, tol) in approx.items():
            what = f"{name}(wells_model()).fit(" + (
                "draws=1,000, chains=4)" if name == "Laplace" else "n=2,000, draws=1,000, chains=4)")
            if name == "Laplace":
                res = timed_call(what, lambda: fitter.fit(draws=1000, chains=4, seed=0), timings)
                extra = f"warnings {res.warnings}"
            else:
                res = timed_call(what, lambda: fitter.fit(n=2000, draws=1000, chains=4, seed=0),
                                 timings)
                extra = (f"{1e3 * timings[what]['wall_s'] / 2000:.3f} ms an Adam step (with"
                         f" the draws' log-likelihood), -ELBO {res.elbo_trace[-1]:.3f}")
            lw = pl.models.compute_log_weights(fitter)
            what_l = f"loo_approximate_posterior({name} of wells)"
            loo = timed_call(what_l, lambda: pl.loo_approximate_posterior(
                res.idata, lw, np.zeros_like(lw), pointwise=True, seed=0), timings)
            d = loo["elpd_loo"] - ref
            check(abs(d) <= tol and np.isfinite(lw).all(),
                  f"{what}: {timings[what]['wall_s']:.3f} s, {extra}; elpd_loo"
                  f" {loo['elpd_loo']:.3f} against the PSIS {ref:.3f} of phase 10c's Laplace"
                  f" draws (d {d:+.3f}, {tol} allowed); {int(np.sum(loo.pareto_k.values > 0.7))}"
                  f" observations k > 0.7")

        # (d) loo_nonfactor on a joint MVN, N = 512, S = 4,000, and one
        # chunk of the benchmark's GP at N = 2,048 and 2,100
        phase_nonfactor(pl, timings)
        phase_nonfactor_chunk()

    launched = {what: t["launches"] for what, t in timings.items() if any(t["launches"].values())}
    check(not launched, "phase 11 runs in float64 and launches none of kernels A to D in any of"
          f" its {len(timings)} windows" + (f"; launched: {launched}" if launched else ""))
    print(f"  card  {smi}", flush=True)


def phase_nonfactor(pl, timings: dict, n: int = 512, chains: int = 4, draws: int = 1000,
                    seed: int = 11) -> None:
    """Phase 11d: ``loo_nonfactor`` on a joint MVN of ``n`` observations with
    an exponential-kernel covariance, sigma^2 exp(-d / ell) + tau^2 I, at
    ``n`` points on [0, 100]; each draw's mean, sigma, ell and tau are
    jittered around the truth (the way ``tests/test_nonfactor.py``'s fixture
    draws them).  The (S, n, n) float64 matrices are made on the card a
    chunk at a time into one host array, which ``loo_nonfactor`` copies back
    a chunk of draws at a time."""
    import numpy as np
    import torch

    from pyloo_tpu_torch.ops import nonfactor

    S = chains * draws
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 100.0, n))
    dist = torch.tensor(np.abs(x[:, None] - x[None, :]), device="cuda")
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    truth = np.array([1.0, 10.0, 0.3])  # sigma, ell, tau
    mu_true = rng.normal(0.0, 1.0, n)
    y = rng.multivariate_normal(
        mu_true, truth[0] ** 2 * np.exp(-np.abs(x[:, None] - x[None, :]) / truth[1])
        + truth[2] ** 2 * np.eye(n))
    mus = mu_true + rng.normal(0.0, 0.05, size=(chains, draws, n))
    theta = truth * np.exp(rng.normal(0.0, 0.05, size=(S, 3)))
    df = rng.uniform(4.0, 30.0, size=(chains, draws))
    gb = S * n * n * 8 / 1e9
    t = time.perf_counter()
    mats = np.empty((chains, draws, n, n))
    print(f"phase 11d: loo_nonfactor at N = {n}, S = {S} ({gb:.1f} GB of float64 matrices,"
          f" {math.ceil(S / nonfactor.draws_per_chunk(n))} chunks of"
          f" {nonfactor.draws_per_chunk(n)} draws)", flush=True)

    def fill(kind):
        """The draws' covariances, precisions or diagonal covariances into ``mats``."""
        flat = torch.from_numpy(mats.reshape(S, n, n))
        th = torch.tensor(theta, device="cuda")
        for a in range(0, S, 250):
            part = th[a:a + 250, :, None, None]
            s2, ell, tau2 = part[:, 0] ** 2, part[:, 1], part[:, 2] ** 2
            if kind == "diag":
                block = (s2 + tau2) * eye
            else:
                block = s2 * torch.exp(-dist / ell) + tau2 * eye
                if kind == "prec":
                    block = torch.cholesky_inverse(torch.linalg.cholesky(block))
            flat[a:a + 250].copy_(block)

    def posterior(**extra):
        return pl.from_dict(posterior={"mu": mus, **extra}, observed_data={"y": y})

    fill("cov")
    print(f"  made the covariances in {time.perf_counter() - t:.1f} s (set-up)", flush=True)
    res = {}
    for form, idata, kw in (("cov", posterior(cov=mats), {}),
                            ("student_t", posterior(cov=mats, df=df), {"model_type": "student_t"})):
        what = f"loo_nonfactor({form}, N = {n}, S = {S})"
        res[form] = timed_call(what, lambda: pl.loo_nonfactor(idata, pointwise=True, reff=1.0,
                                                              **kw), timings)
        if form == "cov":  # once more with its chunks of draws dealt over the mesh
            mesh = smoke_mesh()
            what_m = f"{what} over {mesh}"
            with default_mesh_of(mesh):
                meshed = timed_call(what_m, lambda: pl.loo_nonfactor(
                    idata, pointwise=True, reff=1.0, **kw), timings)
            check(meshed["elpd_loo"] == res[form]["elpd_loo"]
                  and result_digest(meshed) == result_digest(res[form]),
                  f"11d (phase 13's mesh): loo_nonfactor(cov) with its chunks of draws dealt"
                  f" over {mesh.size} shards equals one device bit for bit (elpd_loo, loo_i,"
                  f" pareto_k; {timings[what_m]['wall_s']:.3f} s against"
                  f" {timings[what]['wall_s']:.3f} s)")
        if form == "cov":  # the streamed entry on the same matrices, copied a chunk at a time
            flat, mu_card = mats.reshape(S, n, n), torch.from_numpy(mus.reshape(S, n)).cuda()
            what_s = f"loo_nonfactor_streaming(cov, N = {n}, S = {S})"
            streamed = timed_call(what_s, lambda: pl.loo_nonfactor_streaming(
                y, mu_card, lambda idx: torch.from_numpy(
                    flat[int(idx[0]):int(idx[-1]) + 1]).to(idx.device),
                S, chains=chains, reff=1.0, pointwise=True), timings)
            check(streamed["elpd_loo"] == res[form]["elpd_loo"]
                  and result_digest(streamed) == result_digest(res[form]),
                  f"11d: {what_s}, each chunk's covariances handed over by its matrix"
                  f" function, equals {what} on the same matrices bit for bit (elpd_loo,"
                  f" loo_i, pareto_k; {timings[what_s]['wall_s']:.3f} s against"
                  f" {timings[what]['wall_s']:.3f} s; launches"
                  f" {timings[what_s]['launches']})")
            del mu_card
        # the card against the port's CPU path on the first 64 draws: the
        # estimates within 1e-10; k in two parts, the conditional
        # log-likelihoods within 1e-10 and PSIS on the card against PSIS on
        # the CPU of the same log-likelihoods within 1e-10, and end to end
        # within 1e-10 more than what k moves on the CPU when its input
        # moves from the CPU's log-likelihoods to the card's (its conditioning)
        cut = pl.from_dict(posterior={"mu": mus[:1, :64], "cov": mats[:1, :64],
                                      "df": df[:1, :64]}, observed_data={"y": y})
        card = pl.loo_nonfactor(cut, pointwise=True, reff=1.0, **kw)
        host = on_cpu(pl, lambda: pl.loo_nonfactor(cut, pointwise=True, reff=1.0, **kw))
        d = {key: float(np.max(np.abs(np.asarray(card[key]) - np.asarray(host[key]))))
             for key in ("elpd_loo", "p_loo", "loo_i", "pareto_k")}
        cond, extra = ((nonfactor.mvn_conditional_loglik, ()) if form == "cov" else
                       (nonfactor.mvt_conditional_loglik, (df[0, :64],)))
        ll_card = cond(y, mus[0, :64], *extra, cov=mats[0, :64]).cpu().numpy()
        ll_host = on_cpu(pl, lambda: cond(y, mus[0, :64], *extra, cov=mats[0, :64]).numpy())
        k_host_on_card_ll = np.asarray(on_cpu(pl, lambda: pl.psislw(-ll_card.T, reff=1.0)[1]))
        k_card = np.asarray(card.pareto_k.values)
        d_ll = float(np.max(np.abs(ll_card - ll_host)))
        d_k_psis = float(np.max(np.abs(k_card - k_host_on_card_ll)))
        d_k_cond = float(np.max(np.abs(k_host_on_card_ll - host.pareto_k.values)))
        worst = int(np.argmax(np.abs(k_card - host.pareto_k.values)))
        r = res[form]
        check(np.isfinite(r.loo_i.values).all()
              and max(d["elpd_loo"], d["p_loo"], d["loo_i"], d_ll, d_k_psis) <= 1e-10
              and d["pareto_k"] <= d_k_cond + 1e-10,
              f"{what}: {timings[what]['wall_s']:.3f} s, peak device memory"
              f" {timings[what]['peak_gb']:.3f} GB; elpd_loo {r['elpd_loo']:.3f}, p_loo"
              f" {r['p_loo']:.3f}, {int(np.sum(r.pareto_k.values > 0.7))} of {n} k > 0.7; on 64"
              f" draws the card against the CPU, max |d| (1e-10): "
              + ", ".join(f"{key} {v:.3g}" for key, v in d.items() if key != "pareto_k")
              + f", the conditional log-likelihoods {d_ll:.3g}, k of PSIS on the same"
              f" log-likelihoods {d_k_psis:.3g}; k end to end {d['pareto_k']:.3g} (observation"
              f" {worst}, k {host.pareto_k.values[worst]:.4f}) within 1e-10 of k's own move on"
              f" the CPU from its log-likelihoods to the card's, {d_k_cond:.3g}"
              f" ({d_k_cond / max(d_ll, 1e-300):.3g} times their max |d|)")
        if form == "cov":
            # where a call's time goes: one chunk's pageable copy to the card
            # and its factorisation, solves and log-densities (CUDA events)
            chunk = nonfactor.draws_per_chunk(n)
            flat = mats.reshape(S, n, n)
            y_card = torch.from_numpy(y).cuda()
            mu_card = torch.from_numpy(mus.reshape(S, n)[:chunk]).cuda()
            cov_card = torch.from_numpy(flat[:chunk]).cuda()
            stage = {"copy": median_ms(lambda: torch.from_numpy(flat[:chunk]).cuda(), runs=3),
                     "factor": median_ms(lambda: nonfactor._precision_terms(
                         y_card, mu_card, cov=cov_card), runs=3)}
            n_chunks = math.ceil(S / chunk)
            wall_ms = 1e3 * timings[what]["wall_s"]
            print(f"  time  one chunk of {chunk} draws ({flat[:chunk].nbytes / 1e9:.3f} GB):"
                  f" pageable copy {stage['copy']:.3f} ms"
                  f" ({flat[:chunk].nbytes / stage['copy'] / 1e6:.2f} GB/s), Cholesky,"
                  f" inverse factor and terms {stage['factor']:.3f} ms; x {n_chunks} chunks:"
                  f" copies {n_chunks * stage['copy']:.1f} ms"
                  f" ({100 * n_chunks * stage['copy'] / wall_ms:.1f}% of the"
                  f" {wall_ms:.1f} ms call), factorisations {n_chunks * stage['factor']:.1f} ms"
                  f" ({100 * n_chunks * stage['factor'] / wall_ms:.1f}%)", flush=True)
            del mu_card, cov_card
    t = time.perf_counter()
    fill("prec")
    print(f"  made the precisions in {time.perf_counter() - t:.1f} s (set-up)", flush=True)
    what = f"loo_nonfactor(prec, N = {n}, S = {S})"
    res["prec"] = timed_call(what, lambda: pl.loo_nonfactor(posterior(prec=mats), pointwise=True,
                                                            reff=1.0), timings)
    d_i = float(np.abs(res["prec"].loo_i.values - res["cov"].loo_i.values).max())
    d_e = abs(res["prec"]["elpd_loo"] - res["cov"]["elpd_loo"]) / abs(res["cov"]["elpd_loo"])
    check(d_i <= 1e-8 and d_e <= 1e-8,
          f"{what}: {timings[what]['wall_s']:.3f} s, peak device memory"
          f" {timings[what]['peak_gb']:.3f} GB; against the cov form: max |d loo_i| {d_i:.3g},"
          f" relative d elpd_loo {d_e:.3g} (1e-8 each)")
    t = time.perf_counter()
    fill("diag")
    print(f"  made the diagonal covariances in {time.perf_counter() - t:.1f} s (set-up)",
          flush=True)
    what = f"loo_nonfactor(diagonal cov, N = {n}, S = {S})"
    diag = timed_call(what, lambda: pl.loo_nonfactor(posterior(cov=mats), pointwise=True,
                                                     reff=1.0), timings)
    var = (theta[:, 0] ** 2 + theta[:, 2] ** 2).reshape(chains, draws, 1)
    ll = -0.5 * np.log(2 * np.pi * var) - 0.5 * (y - mus) ** 2 / var
    plain = pl.loo(pl.from_dict(posterior={"mu": mus}, log_likelihood={"obs": ll}),
                   pointwise=True, reff=1.0)
    d = float(np.abs(diag.loo_i.values - plain.loo_i.values).max())
    check(d <= 1e-8, f"{what}: {timings[what]['wall_s']:.3f} s; against loo() of the pointwise"
          f" normal log-likelihood: max |d loo_i| {d:.3g} (1e-8), elpd_loo"
          f" {diag['elpd_loo']:.3f} / {plain['elpd_loo']:.3f}")


def phase_nonfactor_chunk(sizes=(2048, 2100), draws: int = 8, seed: int = 11) -> None:
    """Phase 11d at the benchmark cell's size: one chunk of ``draws``
    squared-exponential covariances, ``alpha^2 exp(-d^2 / (2 rho^2)) +
    sigma^2 I`` at points on [0, 10] with (alpha, rho, sigma) jittered
    around (1, 1, 0.3), made on the card at each N of ``sizes`` (2,048 the
    cell's, its inverse factor split evenly; 2,100 unevenly).  The merged
    inverse factor is held to the triangular solve against the identity
    (1e-14 relative), and the batched Cholesky, the merged inverse and the
    solve are timed (CUDA events)."""
    import torch

    from pyloo_tpu_torch.ops import nonfactor

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for n in sizes:
        x = 10.0 * torch.rand(n, dtype=torch.float64, device="cuda", generator=gen)
        d2 = (x[:, None] - x[None, :]).square()
        theta = torch.tensor([1.0, 1.0, 0.3], dtype=torch.float64, device="cuda") * torch.exp(
            0.05 * torch.randn(draws, 3, dtype=torch.float64, device="cuda", generator=gen))
        alpha, rho, sigma = (theta[:, i, None, None] for i in range(3))
        eye = torch.eye(n, dtype=torch.float64, device="cuda")
        cov = alpha.square() * torch.exp(-d2 / (2 * rho.square())) + sigma.square() * eye
        chol, info = torch.linalg.cholesky_ex(cov)
        want = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
        got = nonfactor._tri_inverse(chol)
        rel = float((got - want).abs().max() / want.abs().max())
        ms = {"Cholesky": median_ms(lambda: torch.linalg.cholesky_ex(cov), runs=5),
              "merged inverse": median_ms(lambda: nonfactor._tri_inverse(chol), runs=5),
              "solve": median_ms(lambda: torch.linalg.solve_triangular(
                  chol, eye.expand_as(chol), upper=False), runs=5)}
        check(int(info.abs().sum()) == 0 and torch.equal(torch.tril(got), got) and rel <= 1e-14,
              f"11d: one chunk of {draws} GP covariances at N = {n}: the merged inverse factor"
              f" against the triangular solve, max |d| / max |L^-1| {rel:.3g} (1e-14); a chunk's"
              f" batched Cholesky {ms['Cholesky']:.3f} ms, merged inverse"
              f" {ms['merged inverse']:.3f} ms, solve {ms['solve']:.3f} ms")
        del cov, chol, want, got


def first_use_child(mode: str, reff: float) -> None:
    """Phase 12a in a fresh process: import the package, ``warmup`` first
    when ``mode`` is "warmup", make phase 5's model on the card, then run
    phase 5's ``loo_streaming`` (twice without warmup, once after it); each
    step timed, the kernel launches of each window counted.  Prints one
    line, ``CHILD`` and a JSON object."""
    t = time.perf_counter()
    import torch

    import pyloo_tpu_torch as pl

    out = {"mode": mode, "import_s": time.perf_counter() - t, "calls": []}
    from bench_torch import model as bench_model

    torch.backends.cuda.matmul.allow_tf32 = False
    pl.rcParams["device.device"] = "cuda"
    n_obs, s = 1_000_000, 4_000
    if mode == "warmup":
        zero_counts()
        t = time.perf_counter()
        out["warmup"] = pl.warmup(n_obs, s, dtype=torch.float32)
        out["warmup_s"] = time.perf_counter() - t
        out["warmup_launches"] = read_counts()
    t = time.perf_counter()
    model = bench_model.logistic_model(n_obs, 4, 1_000, 7, "cuda")
    torch.cuda.synchronize()
    out["model_s"] = time.perf_counter() - t
    log_lik_fn = bench_model.log_lik_fn(model)
    for _ in range(1 if mode == "warmup" else 2):
        zero_counts()
        t = time.perf_counter()
        res = pl.loo_streaming(log_lik_fn, n_obs, s, reff=reff, dtype="float32", pointwise=True)
        out["calls"].append({"wall_s": time.perf_counter() - t, "launches": read_counts(),
                             "elpd_loo": res["elpd_loo"], "digest": result_digest(res)})
    print("CHILD " + json.dumps(out), flush=True)


def write_stan_csv(path: str, ll, params: dict, chain: int, seed: int) -> str:
    """One chain's CmdStan output file: the comment header, the sampler's
    diagnostic columns, the parameters (name -> (draws,)) and
    ``log_lik.1`` ... ``log_lik.n`` of ``ll`` (draws, n), the adaptation
    block, the draws in ``%.17g`` (exact for float64) and the timing footer."""
    import numpy as np

    draws, n = ll.shape
    rng = np.random.default_rng([seed, chain])
    diag = ["lp__", "accept_stat__", "stepsize__", "treedepth__", "n_leapfrog__",
            "divergent__", "energy__"]
    lp = ll.astype(np.float64).sum(axis=1)
    stats = np.stack([lp, rng.uniform(0.6, 1.0, draws), np.full(draws, 0.31), np.full(draws, 3.0),
                      np.full(draws, 7.0), (rng.random(draws) < 0.01).astype(float),
                      -lp + rng.exponential(size=draws)], axis=1)
    rows = np.concatenate([stats] + [v[:, None] for v in params.values()]
                          + [ll.astype(np.float64)], axis=1)
    fmt = ",".join(["%.17g"] * rows.shape[1])
    lines = ["# stan_version_major = 2", "# stan_version_minor = 36", "# model = logistic_model",
             "# method = sample (Default)", "#   sample", f"#     num_samples = {draws}",
             f"#     num_warmup = {draws}", "#     save_warmup = 0 (Default)", f"# id = {chain + 1}",
             ",".join(diag + list(params) + [f"log_lik.{i + 1}" for i in range(n)]),
             "# Adaptation terminated", "# Step size = 0.31",
             "# Diagonal elements of inverse mass matrix:", "# " + ", ".join(["1"] * len(params))]
    lines += [fmt % tuple(row) for row in rows.tolist()]
    lines += ["# ", "#  Elapsed Time: 1.2 seconds (Warm-up)", "#                1.1 seconds (Sampling)"]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def write_stan_csvs(directory: str, ll, params: dict, seed: int) -> list:
    """CmdStan output files of ``ll`` (chain, draw, n) and ``params``
    (name -> (chain, draw)), one a chain.  Returns the paths."""
    return [write_stan_csv(os.path.join(directory, f"logistic_{c + 1}.csv"), ll[c],
                           {k: v[c] for k, v in params.items()}, c, seed)
            for c in range(ll.shape[0])]


def eight_schools_bridge(device: str):
    """Eight schools, non-centred, as PyMC's PyTorch backend would compile
    it: value variables mu, tau_log__ (HalfCauchy(5), log transform) and
    theta_t (8), torch functions over tensors on ``device``."""
    import numpy as np
    import torch

    from pyloo_tpu_torch.models.pymc_adapter import PyTensorJaxBridge

    y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
    yt, st = torch.tensor(y, device=device), torch.tensor(sigma, device=device)

    def log_lik(p):
        mean = p["mu"] + torch.exp(p["tau_log__"]) * p["theta_t"]
        return -0.5 * math.log(2 * math.pi) - torch.log(st) - 0.5 * ((yt - mean) / st) ** 2

    def logp(p):
        tau = torch.exp(p["tau_log__"])
        prior = (-0.5 * (p["mu"] / 5.0) ** 2 - torch.log1p((tau / 5.0) ** 2) + p["tau_log__"]
                 - 0.5 * torch.sum(p["theta_t"] ** 2))
        return prior + torch.sum(log_lik(p))

    return PyTensorJaxBridge(
        name="eight_schools_noncentered",
        param_shapes={"mu": (), "tau_log__": (), "theta_t": (8,)},
        logp=logp, log_lik=log_lik, observed={"y": y},
        constrain=lambda p: {"mu": p["mu"], "tau": torch.exp(p["tau_log__"]),
                             "theta_t": p["theta_t"]},
        forward=lambda c: {"mu": c["mu"], "tau_log__": torch.log(c["tau"]),
                           "theta_t": c["theta_t"]},
        free_names=("mu", "tau", "theta_t"),
    )


def phase_first_use(pl, smi: str, model, reff: float, phase5: dict, ll_wells) -> None:
    """Phase 12: warmup and a cold process's first call, CmdStan ingestion
    into loo(), a trace of loo_streaming, and the PyMC bridge on the card."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pyloo_tpu_torch.models import pymc_adapter
    from pyloo_tpu_torch.models.wrapper import map_draws
    from pyloo_tpu_torch.profiling import Throughput, annotate, trace
    from bench_torch import model as bench_model

    print(f"phase 12: warmup, ingestion, profiling and the PyMC bridge ({smi})", flush=True)
    pl.rcParams["device.device"] = "cuda"
    t_phase = time.perf_counter()

    # (a) two cold processes, one warmed up: their walls and results
    torch.cuda.empty_cache()  # this process's cached blocks, for the children
    root = os.path.dirname(os.path.abspath(__file__))
    kids = {}
    for mode in ("plain", "warmup"):
        code = (f"import sys; sys.path.insert(0, {root!r}); import chip_smoke;"
                f" chip_smoke.first_use_child({mode!r}, {float(reff)!r})")
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=300)
        lines = [line for line in proc.stdout.splitlines() if line.startswith("CHILD ")]
        ok = proc.returncode == 0 and bool(lines)
        check(ok, f"12a: the {mode} process ran (exit {proc.returncode},"
              f" {time.perf_counter() - t:.1f} s){'' if ok else ': ' + proc.stderr[-2000:]}")
        if not ok:
            return
        kids[mode] = json.loads(lines[-1][len("CHILD "):])
        for call in kids[mode]["calls"]:
            PATH_LAUNCHES["A"] += call["launches"]["A"]
    plain, warm = kids["plain"], kids["warmup"]
    PATH_LAUNCHES["A"] += warm["warmup_launches"]["A"]
    got = warm["warmup"]
    print(f"  time  cold process without warmup: import {plain['import_s']:.3f} s, model (and"
          f" the CUDA context) {plain['model_s']:.3f} s, first loo_streaming"
          f" {plain['calls'][0]['wall_s']:.3f} s, second {plain['calls'][1]['wall_s']:.3f} s"
          f" (phase 5 in this process: {phase5['wall_s']:.3f} s)", flush=True)
    print(f"  time  cold process with warmup: import {warm['import_s']:.3f} s, warmup"
          f" {warm['warmup_s']:.3f} s (its wall_s {got['wall_s']:.3f}, library loaded, not built:"
          f" {got['compilation_cache']}), model {warm['model_s']:.3f} s, first loo_streaming"
          f" {warm['calls'][0]['wall_s']:.3f} s", flush=True)
    check(got["chunk_size"] == phase5["chunk"] and got["dtype"] == "float32",
          f"12a: warmup's chunk_size {got['chunk_size']} is the {phase5['chunk']} rows"
          f" loo_streaming resolves")
    check(warm["warmup_launches"]["A"] >= 1 and got["compilation_cache"],
          f"12a: kernel A launched {warm['warmup_launches']['A']} time(s) in warmup's window;"
          f" the library built by phase 0 was loaded")
    calls = plain["calls"] + warm["calls"]
    check(all(c["elpd_loo"] == phase5["elpd_loo"] and c["digest"] == phase5["digest"]
              and c["launches"]["A"] == phase5["n_chunks"] for c in calls),
          f"12a: the {len(calls)} calls of the cold processes equal phase 5 bit for bit"
          f" (elpd_loo, loo_i, pareto_k; A {[c['launches']['A'] for c in calls]} a call)")
    # a float64 warmup uses no kernel of the library: it loads and launches nothing
    from pyloo_tpu_torch import _build

    real_load, loads = _build.load, []
    _build.load = lambda *a, **k: loads.append(1) or real_load(*a, **k)
    try:
        zero_counts()
        got64 = pl.warmup(1_000_000, 4_000, dtype=torch.float64)
        launched = read_counts()
    finally:
        _build.load = real_load
    check(not loads and not any(launched.values()) and got64["compilation_cache"] is False,
          f"12a: a float64 warmup loaded the kernel library {len(loads)} times and launched"
          f" {sum(launched.values())} kernels (0 and 0); {got64['wall_s']:.3f} s, chunk"
          f" {got64['chunk_size']}")

    # (b) CmdStan CSV files of wells' size into loo()
    tmp = tempfile.mkdtemp(prefix="pyloo_stan_")
    try:
        chains, draws, n = ll_wells.shape
        rng = np.random.default_rng(12)
        params = {"alpha": rng.normal(size=(chains, draws)),
                  "beta": rng.normal(0.5, 0.1, size=(chains, draws))}
        t = time.perf_counter()
        paths = write_stan_csvs(tmp, ll_wells, params, seed=13)
        write_s = time.perf_counter() - t
        mb = sum(os.path.getsize(p) for p in paths) / 1e6
        pattern = os.path.join(tmp, "logistic_*.csv")
        t = time.perf_counter()
        idata = pl.from_cmdstan(pattern)
        parse_s = time.perf_counter() - t
        t = time.perf_counter()
        routed = pl.to_inference_data(pattern)
        routed_s = time.perf_counter() - t
        print(f"  time  {len(paths)} Stan CSV files, {mb:.1f} MB, written in {write_s:.3f} s;"
              f" from_cmdstan parsed them in {parse_s:.3f} s ({mb / parse_s:.1f} MB/s),"
              f" to_inference_data in {routed_s:.3f} s ({mb / routed_s:.1f} MB/s)", flush=True)
        ref = pl.from_dict(posterior=params, log_likelihood={"log_lik": ll_wells.astype(np.float64)})
        same = all(np.array_equal(d.log_likelihood["log_lik"].values,
                                  ref.log_likelihood["log_lik"].values)
                   and all(np.array_equal(d.posterior[k].values, params[k]) for k in params)
                   for d in (idata, routed))
        check(same and idata.sample_stats["diverging"].values.dtype == bool,
              f"12b: the parsed draws {idata.log_likelihood['log_lik'].values.shape} equal the"
              " written ones bit for bit (from_cmdstan and to_inference_data)")
        for precision in ("float32", "float64"):
            pl.rcParams["device.precision"] = precision
            zero_counts()
            t = time.perf_counter()
            res = pl.loo(idata, pointwise=True)
            wall = time.perf_counter() - t
            launched = read_counts()
            want = pl.loo(ref, pointwise=True)
            from_routed = pl.loo(routed, pointwise=True)
            equal = all(r["elpd_loo"] == want["elpd_loo"] and r["p_loo"] == want["p_loo"]
                        and result_digest(r) == result_digest(want) for r in (res, from_routed))
            a_ok = launched["A"] > 0 if precision == "float32" else launched["A"] == 0
            check(equal and a_ok, f"12b: loo() {precision} of the CmdStan draws equals loo() of"
                  f" the same matrix through from_dict bit for bit (elpd_loo {res['elpd_loo']:.6f},"
                  f" {wall:.3f} s); kernel A launched {launched['A']} time(s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pl.rcParams["device.precision"] = "float64"

    # (c) phase 5's loo_streaming under trace(), its kernels named in the file
    log_dir = tempfile.mkdtemp(prefix="pyloo_trace_")
    try:
        n_obs, s = model[0].shape[0], model[2].shape[0] * model[2].shape[1]
        meter = Throughput()
        zero_counts()
        t = [time.perf_counter()]
        with trace(log_dir):
            t.append(time.perf_counter())  # the profiler started
            with meter.measure(n_items=n_obs), annotate("loo_streaming"):
                res = pl.loo_streaming(bench_model.log_lik_fn(model), n_obs, s, reff=reff,
                                       dtype="float32", pointwise=True)
                torch.cuda.synchronize()
        t.append(time.perf_counter())  # stopped and exported
        launched = read_counts()
        files = [f for f in os.listdir(log_dir) if f.startswith("trace_")]
        events = []
        if files:
            with open(os.path.join(log_dir, files[0])) as fh:
                events = json.load(fh)["traceEvents"]
        named = sum(1 for e in events if e.get("name") == "loo_streaming")
        kernel_a = sum(1 for e in events if e.get("cat") == "kernel"
                       and "loo_prepass_kernel<true" in e.get("name", ""))
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        size = sum(os.path.getsize(os.path.join(log_dir, f)) for f in files) / 1e6
        print(f"  time  traced loo_streaming {meter.summary()}, against phase 5's"
              f" {phase5['wall_s']:.3f} s; the profiler's start {t[1] - t[0]:.3f} s, its stop and"
              f" export {t[2] - t[1] - meter.total_seconds:.3f} s; trace {size:.1f} MB,"
              f" {kernels} kernels on the card", flush=True)
        check(len(files) == 1 and named >= 1 and kernel_a == launched["A"] == phase5["n_chunks"]
              and result_digest(res) == phase5["digest"],
              f"12c: the trace names the annotation ({named}) and kernel A {kernel_a} times,"
              f" the launch counter {launched['A']}; the result equals phase 5 bit for bit")
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)

    # (d) the PyMC bridge of eight schools on the card against the CPU
    draws = np.random.default_rng(14).normal(0.0, 0.8, size=(4 * 1_000, 10))
    out = {}
    for device in ("cuda", "cpu"):
        pl.rcParams["device.device"] = device
        bridge = eight_schools_bridge(device)
        wrapper = pl.PyMCWrapper(pymc_adapter.from_bridge(bridge))
        q = torch.tensor(draws, device=device)
        lp = torch.func.vmap(wrapper.model.logp_flat)(q)
        ll = map_draws(wrapper.model.log_lik_flat, q, wrapper.n_obs)
        devices = {lp.device.type, ll.device.type} | {
            v.device.type for v in wrapper.model.tensor_data(device).values()}
        posterior = {"mu": draws[:, 0].reshape(4, 1_000), "tau": np.exp(draws[:, 1]).reshape(4, 1_000),
                     "theta_t": draws[:, 2:].reshape(4, 1_000, 8)}
        foreign = pl.from_dict(posterior=posterior)
        ingested = pymc_adapter.ingest_pymc_idata(bridge, wrapper.model, foreign)
        out[device] = (lp.cpu().numpy(), ll.cpu().numpy(), devices,
                       ingested.log_likelihood["obs"].values)
    pl.rcParams["device.device"] = "cuda"
    (lp_c, ll_c, dev_c, ing_c), (lp_h, ll_h, _, ing_h) = out["cuda"], out["cpu"]
    d_lp = float(np.abs(lp_c - lp_h).max())
    d_ll = max(float(np.abs(ll_c - ll_h).max()), float(np.abs(ing_c - ing_h).max()))
    check(dev_c == {"cuda"} and np.allclose(lp_c, lp_h, rtol=1e-12, atol=1e-12)
          and np.allclose(ll_c, ll_h, rtol=1e-12, atol=1e-12)
          and np.allclose(ing_c, ing_h, rtol=1e-12, atol=1e-12),
          f"12d: the bridge model's log density and log-likelihood over 4 x 1,000 draws on the"
          f" card against the CPU: max |d logp| {d_lp:.3g}, max |d log_lik| {d_ll:.3g}"
          f" (rtol/atol 1e-12); its tensors on {sorted(dev_c)}")
    print(f"  time  phase 12 {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_mesh(pl, smi: str, model, reff: float, phase5: dict, ll_cut) -> None:
    """Phase 13: the multi-device layer.  Over ``smoke_mesh()``: the
    launchers keep the caller's current device (two cards or more); phase
    5's ``loo_streaming`` with the model copied to each card of the mesh,
    per row equal to the same call with no mesh, kernel A launched once a
    shard and chunk, and a transfer census of the call (no copy between
    cards larger than a scalar); ``loo()`` in float32 and float64 on phase
    6's 262,144-row cut, per row equal to one device.  Each call's wall
    beside its wall with no mesh."""
    import numpy as np
    import torch

    from pyloo_tpu_torch.ops import topk
    from pyloo_tpu_torch.parallel import Mesh, witness
    from pyloo_tpu_torch.streaming._chunks import resolve_chunk
    from bench_torch import model as bench_model

    n_cards = torch.cuda.device_count()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(f"phase 13: the multi-device layer, {n_cards} card(s) ({smi})", flush=True)
    print(f"  cards {n_cards}: " + "; ".join(f"cuda:{i} {c}" for i, c in enumerate(cards)),
          flush=True)
    mesh = smoke_mesh()
    used = sorted({str(d) for d in mesh.devices})
    print(f"  mesh {mesh}: {mesh.size} shards on {len(used)} card(s)"
          + ("" if len(used) > 1 else "; on one card the walls below are the split's cost,"
             " not a speed-up, and no speed-up is claimed"), flush=True)
    pl.rcParams["device.device"] = "cuda"
    t_phase = time.perf_counter()

    # (a) a launch on another card than the current one leaves the current one
    if n_cards >= 2:
        torch.cuda.set_device(0)
        x = torch.randn(1024, 4000, device="cuda:1") * 0.8 + 1.0
        before = torch.cuda.current_device()
        vals = topk.loo_prepass(x, 200)[0]
        top = topk.topk_desc(x, 200)
        after = torch.cuda.current_device()
        torch.cuda.synchronize(1)
        same = (torch.equal(vals, topk.loo_prepass_plain(x, 200)[0])
                and torch.equal(top, topk.topk_desc_plain(x, 200)))
        check(before == after == 0 and vals.device == x.device and same,
              f"13a: kernels A and B on cuda:1 with cuda:0 current: current device {before}"
              f" before, {after} after; their values equal the plain versions' on cuda:1")
        del x, vals, top

    # (b) phase 5's loo_streaming over the mesh, the model on each card
    n_obs, s = model[0].shape[0], model[2].shape[0] * model[2].shape[1]
    copies = {d: tuple(t.to(d) for t in model) for d in set(mesh.devices)}
    fns = {d: bench_model.log_lik_fn(copies[d]) for d in copies}

    def log_lik_fn(idx):  # the generator contract over a mesh: rows on idx.device
        return fns[idx.device](idx)

    chunk, n_chunks = resolve_chunk(None, n_obs, s, torch.float32, mesh=mesh)
    kw = dict(reff=reff, dtype="float32", pointwise=True)

    def sync_all():
        for index in range(n_cards):
            torch.cuda.synchronize(index)

    def turns(fn_none, fn_mesh):
        """no mesh, mesh, mesh, no mesh, each a launch window of its own,
        after the untimed call over the mesh that ran before: the walls and
        the first call of each with its launches (all, and a card)."""
        got, walls = {}, {"no mesh": [], "mesh": []}
        for what in ("no mesh", "mesh", "mesh", "no mesh"):
            sync_all()
            zero_counts()
            t = time.perf_counter()
            out, per_device = witness.launch_census(fn_mesh if what == "mesh" else fn_none)
            sync_all()
            walls[what].append(time.perf_counter() - t)
            launched = read_counts()
            got.setdefault(what, (out, per_device, launched))
        return got, walls

    # the census run comes first: it is also the first use of every card
    with warnings_quiet():
        (_, census) = witness.transfer_census(
            lambda: pl.loo_streaming(log_lik_fn, n_obs, s, mesh=mesh, **kw))
    got, walls = turns(lambda: pl.loo_streaming(log_lik_fn, n_obs, s, **kw),
                       lambda: pl.loo_streaming(log_lik_fn, n_obs, s, mesh=mesh, **kw))
    none, res = got["no mesh"][0], got["mesh"][0]
    _, per_device, launched = got["mesh"]
    shards_on = {d: sum(1 for e in mesh.devices if str(e) == d) for d in used}
    per_shard = {d: per_device.get(d, 0) / shards_on[d] for d in used}
    differ = int(np.sum((res.loo_i.values != none.loo_i.values)
                        | (res.pareto_k.values != none.pareto_k.values)))
    check(differ == 0 and result_digest(none) == phase5["digest"],
          f"13b: loo_streaming over the mesh equals the call with no mesh per row bit for bit"
          f" ({differ} rows differ; the call with no mesh equals phase 5:"
          f" {result_digest(none) == phase5['digest']}); elpd_loo {res['elpd_loo']!r} against"
          f" {none['elpd_loo']!r} (the carries summed shard by shard)")
    check(all(n == n_chunks for n in per_shard.values()) and launched["A"] == n_chunks * mesh.size
          and launched["B"] == 0,
          f"13b: kernel A launched once a shard and chunk: {per_device} on the cards, that is"
          f" {per_shard} a shard for {n_chunks} chunks of {chunk} rows ({chunk // mesh.size}"
          f" a shard); A {launched['A']} in all, B {launched['B']}")
    best = {what: min(v) for what, v in walls.items()}
    print(f"  time  loo_streaming at {n_obs} x {s} float32 (no mesh, mesh, mesh, no mesh):"
          f" over the mesh {', '.join(f'{w:.3f}' for w in walls['mesh'])} s, with no mesh"
          f" {', '.join(f'{w:.3f}' for w in walls['no mesh'])} s ({n_obs / best['mesh']:.0f}"
          f" against {n_obs / best['no mesh']:.0f} obs/s at the best)", flush=True)
    summary = ", ".join(f"{kind} {len(v)} ({sum(v)} bytes, largest {max(v, default=0)})"
                        for kind, v in census.items())
    try:
        witness.assert_scalar_only_transfers(census)
        scalar_only = True
    except AssertionError as err:
        scalar_only = False
        summary += f"; {err}"
    check(scalar_only and len(census["device_to_host"]) > 0,
          f"13b: the transfer census of the call: {summary}; no copy between cards larger"
          f" than {witness.SCALAR_BYTES} bytes")
    del res, none, got, copies, fns

    # (c) loo() on phase 6's 262,144-row cut, float32 and float64
    idata = pl.from_dict(posterior={"beta": model[2].cpu().numpy()},
                         log_likelihood={"y": ll_cut})

    def loo_over(one_mesh):
        with default_mesh_of(one_mesh):
            return pl.loo(idata, pointwise=True)

    for precision in ("float32", "float64"):
        pl.rcParams["device.precision"] = precision
        loo_over(mesh)  # untimed: this path's first use of every card
        got, walls = turns(lambda: loo_over(Mesh(["cuda:0"])), lambda: loo_over(mesh))
        a, b = got["mesh"][0], got["no mesh"][0]
        _, per_device, launches = got["mesh"]
        differ = int(np.sum((a.loo_i.values != b.loo_i.values)
                            | (a.pareto_k.values != b.pareto_k.values)))
        want_a = 0 if precision == "float64" else mesh.size
        check(differ == 0 and a["elpd_loo"] == b["elpd_loo"] and launches["A"] == want_a,
              f"13c: loo() {precision} on {ll_cut.shape[2]} rows over the mesh equals one device"
              f" per row bit for bit ({differ} rows differ, max |d loo_i|"
              f" {np.abs(a.loo_i.values - b.loo_i.values).max():.3g}); kernel A"
              f" {launches['A']} ({want_a}: {per_device} on the cards); over the mesh"
              f" {', '.join(f'{w:.3f}' for w in walls['mesh'])} s, with no mesh"
              f" {', '.join(f'{w:.3f}' for w in walls['no mesh'])} s")
    pl.rcParams["device.precision"] = "float64"
    phase_deep_tail(pl, mesh, ll_cut, model, turns)
    print(f"  time  phase 13 {time.perf_counter() - t_phase:.1f} s ({len(used)} card(s) used)",
          flush=True)


def phase_deep_tail(pl, mesh, ll_cut, model, turns, sizes=(65_536, None)) -> None:
    """13d: the float64 deep-tail guard over the mesh.  Row 5 of phase 6's
    cut becomes a t(2) row whose tail lies far below e^-60, which sends its
    decision group to the signed-log fit.  ``pyloo_tpu``'s group is the
    whole call over a mesh and, with no mesh, each of its chunks of 67,108
    rows: at 65,536 rows the two are one group, and the call over the mesh
    equals the one with no mesh bit for bit; at 262,144 rows they are equal
    on the deep row's group, rows 0 to 67,107, and part elsewhere.  Each
    call's host reads of the guard are counted (one a call), and the calls
    with and without the deep row are timed in turns."""
    import numpy as np

    from pyloo_tpu_torch.ops import guard
    from pyloo_tpu_torch.parallel import Mesh, sharding

    reads = [0]
    real_read = guard.host_read

    def counted(flags):
        reads[0] += 1
        return real_read(flags)

    deep_row, s = 5, ll_cut.shape[0] * ll_cut.shape[1]
    saved = ll_cut[:, :, deep_row].copy()
    t2 = np.random.default_rng(8).standard_t(2, size=saved.shape) * 8.0 - 30.0
    guard.host_read = counted
    try:
        for n_rows in (n or ll_cut.shape[2] for n in sizes):
            group = sharding.guard_groups(n_rows, s, 8, None)[0][1]  # the deep row's
            for deep in (False, True):
                ll_cut[:, :, deep_row] = t2 if deep else saved
                idata = pl.from_dict(posterior={"beta": model[2].cpu().numpy()},
                                     log_likelihood={"y": np.ascontiguousarray(
                                         ll_cut[:, :, :n_rows])})
                counts = {}

                def over(one_mesh, idata=idata, counts=counts):
                    reads[0] = 0
                    with default_mesh_of(one_mesh), warnings_quiet():
                        out = pl.loo(idata, pointwise=True)
                    counts.setdefault(one_mesh is mesh, reads[0])
                    return out

                over(mesh)  # untimed: this data's first call
                counts.clear()
                got, walls = turns(lambda: over(Mesh(["cuda:0"])), lambda: over(mesh))
                a, b = got["mesh"][0], got["no mesh"][0]
                dk = np.abs(a.pareto_k.values - b.pareto_k.values)
                same = (np.array_equal(a.loo_i.values, b.loo_i.values)
                        and np.array_equal(a.pareto_k.values, b.pareto_k.values))
                if n_rows > group and deep:
                    ok = (np.array_equal(a.pareto_k.values[:group], b.pareto_k.values[:group])
                          and 0 < dk[group:].max() < 1e-9)
                    want = (f"equal on the deep row's group, rows 0 to {group - 1}, and apart"
                            " elsewhere (another branch), by less than 1e-9")
                else:
                    ok, want = same, "equal bit for bit"
                case = "one deep row" if deep else "no deep row"
                print(f"  time  13d loo() float64, {n_rows} rows, {case}"
                      f" (no mesh, mesh, mesh, no mesh): over the mesh"
                      f" {', '.join(f'{w:.3f}' for w in walls['mesh'])} s, with no mesh"
                      f" {', '.join(f'{w:.3f}' for w in walls['no mesh'])} s", flush=True)
                check(ok and counts == {True: 1, False: 1},
                      f"13d: loo() float64 on {n_rows} rows with"
                      f" {'a' if deep else 'no'} deep-tail row: over the mesh and with no mesh"
                      f" {want} (max |d k| {dk.max():.3g}, elpd_loo {a['elpd_loo']!r} against"
                      f" {b['elpd_loo']!r}); the guard's host reads a call: {counts[True]} over"
                      f" the mesh of {mesh.size} shards, {counts[False]} with no mesh")
                del idata, got, a, b
    finally:
        ll_cut[:, :, deep_row] = saved
        guard.host_read = real_read


# --------------------------------------------------------------------------
# phase 14: edge rows
# --------------------------------------------------------------------------


def edge_rows(b: int, s: int, k: int, gen, device: str = "cuda"):
    """``(b, s)`` float32 x = -log_lik rows whose first ``len(names)`` rows
    are the edge kinds, the rest normal draws; returns ``(x, names)``.  The
    kinds: NaN of either sign (and two other bit patterns), one or many to
    a row, k - 1, k and k + 1 of them, more than the candidate buffer holds,
    a row of NaN; +inf and -inf entries, a row of each; a single finite
    value among -inf and among +inf; subnormals; +-FLT_MAX; +-0.0 at the
    k-th place.  Needs s >= 2 k + 2."""
    import numpy as np
    import torch

    big = torch.finfo(torch.float32).max
    tiny = torch.finfo(torch.float32).smallest_normal * 2.0**-23  # the least subnormal
    x = 1.0 + 0.8 * torch.randn(b, s, device=device, generator=gen)
    pat = torch.from_numpy(np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                                    np.uint32).view(np.float32)).to(device)
    nan, neg_nan, nan_low, neg_nan_ones = pat  # 0-d tensors: assigned bit for bit
    inf = math.inf

    def cols(n):  # n distinct columns
        return torch.randperm(s, device=device, generator=gen)[:n]

    def randint(lo, hi):
        return torch.randint(lo, hi, (s,), device=device, generator=gen).float()

    rows = [
        ("one NaN", lambda r: r.__setitem__(s // 3, nan)),
        ("one -NaN", lambda r: r.__setitem__(7, neg_nan)),
        ("NaN every 7th", lambda r: r.__setitem__(slice(None, None, 7), nan)),
        ("-NaN every 11th", lambda r: r.__setitem__(slice(3, None, 11), neg_nan)),
        ("k - 1 -NaN", lambda r: r.__setitem__(cols(k - 1), neg_nan)),
        ("k NaN", lambda r: r.__setitem__(cols(k), nan)),
        ("k + 1 -NaN", lambda r: r.__setitem__(cols(k + 1), neg_nan)),
        ("NaN bit patterns", lambda r: (r.__setitem__(slice(None, None, 13), nan_low),
                                        r.__setitem__(slice(5, None, 13), neg_nan_ones))),
        ("-NaN in every other", lambda r: r.__setitem__(slice(None, None, 2), neg_nan)),
        ("a row of NaN", lambda r: r.fill_(float("nan"))),
        ("a row of -NaN", lambda r: r.copy_(neg_nan.expand(s))),
        ("NaN, +inf and -inf", lambda r: (r.__setitem__(slice(None, None, 3), nan),
                                          r.__setitem__(slice(1, None, 3), inf),
                                          r.__setitem__(slice(2, None, 5), -inf))),
        ("+inf every 9th", lambda r: r.__setitem__(slice(None, None, 9), inf)),
        ("k - 1 +inf", lambda r: r.__setitem__(cols(k - 1), inf)),
        ("2k +inf", lambda r: r.__setitem__(cols(2 * k), inf)),
        ("a row of +inf", lambda r: r.fill_(inf)),
        ("-inf every 5th", lambda r: r.__setitem__(slice(None, None, 5), -inf)),
        ("a row of -inf", lambda r: r.fill_(-inf)),
        ("one finite among -inf", lambda r: (r.fill_(-inf), r.__setitem__(s // 2, 0.5))),
        ("one finite among +inf", lambda r: (r.fill_(inf), r.__setitem__(s // 2, 0.5))),
        ("subnormals", lambda r: r.copy_(tiny * randint(-100, 100))),
        ("subnormals and normals", lambda r: r.__setitem__(slice(None, None, 2),
                                                           tiny * randint(-100, 100)[::2])),
        ("+-FLT_MAX", lambda r: (r.copy_(big * (2.0 * torch.rand(s, device=device,
                                                               generator=gen) - 1.0)),
                                 r.__setitem__(0, big), r.__setitem__(1, -big))),
        ("+-FLT_MAX and +inf", lambda r: (r.__setitem__(slice(None, None, 2), big),
                                          r.__setitem__(slice(1, None, 2), -big),
                                          r.__setitem__(slice(None, None, 17), inf))),
        ("+-0.0 at the k-th place", lambda r: (
            r.copy_(torch.where(torch.rand(s, device=device, generator=gen) < 0.5, 0.0, -0.0)),
            r.__setitem__(cols(k - 1), 0.1 + torch.rand(k - 1, device=device, generator=gen)),
            r.__setitem__(slice(None, None, 29), -1.0))),
        ("-0.0 below k - 1 +0.0", lambda r: (r.fill_(-0.0), r.__setitem__(cols(k - 1), 0.0))),
    ]
    for i, (_, put) in enumerate(rows):
        put(x[i])
    return x, [name for name, _ in rows]


def hold_edge(kernels: dict, x, k: int, what: str, bitonic: bool = True) -> None:
    """Kernels A and B (and C and D, ``bitonic``) against their plain
    versions, as phases 1 and 1b hold them."""
    hold_prepass(kernels["loo_prepass"], x, k, what)
    hold_topk(kernels["topk_desc"], x, k, what)
    if bitonic:
        for key, (letter, variant, tree, fold) in bitonic_variants().items():
            hold_variant(kernels[key], letter, variant, (tree, fold), x, k, what)


def plant_patterns(s: int, device: str = "cuda"):
    """``(masks, values, names)``: per planted kind, the draws of a
    log-likelihood row it replaces (``masks``, ``(K, s)`` bool) and what it
    puts there (``values``)."""
    import numpy as np
    import torch

    nan, inf = math.nan, math.inf
    neg_nan = torch.from_numpy(np.array([0xFFC00000], np.uint32).view(np.float32))  # bit for bit
    kinds = [
        ("one NaN draw", [(slice(123, 124), nan)]),
        ("NaN every 97th draw", [(slice(None, None, 97), nan)]),
        ("a row of NaN", [(slice(None), nan)]),
        ("-NaN every 50th draw", [(slice(None, None, 50), neg_nan)]),
        ("one -inf draw", [(slice(7, 8), -inf)]),
        ("-inf every 13th draw", [(slice(None, None, 13), -inf)]),
        ("a row of -inf", [(slice(None), -inf)]),
        ("one +inf draw", [(slice(8, 9), inf)]),
        ("+inf every 31st draw", [(slice(None, None, 31), inf)]),
        ("a row of +inf", [(slice(None), inf)]),
        ("one finite draw among -inf", [(slice(None, 11), -inf), (slice(12, None), -inf)]),
        ("NaN, +inf and -inf", [(slice(None, None, 3), nan), (slice(1, None, 7), inf),
                                (slice(2, None, 5), -inf)]),
    ]
    masks = torch.zeros(len(kinds), s, dtype=torch.bool)
    values = torch.zeros(len(kinds), s)
    for i, (_, puts) in enumerate(kinds):
        for where, value in puts:
            masks[i, where] = True
            values[i, where] = value
    return masks.to(device), values.to(device), [name for name, _ in kinds]


def planted_rows(n_obs: int, n_cut: int, n_planted: int = 384, first: int = 1_000,
                 step: int = 641):
    """The planted rows: every ``step``-th from ``first``, all within the
    first ``n_cut`` rows (phase 6's cut)."""
    import numpy as np

    rows = first + step * np.arange(n_planted)
    assert rows[-1] < min(n_obs, n_cut)
    return rows


def planted_chunks(log_lik_fn, n_obs: int, rows, masks, values):
    """``log_lik_fn`` with the planted rows' draws replaced: row ``rows[j]``
    takes kind ``j % K``.  No host read: every row of a chunk goes through
    one ``torch.where``, which leaves the other rows as they were, bit for
    bit."""
    import torch

    device = masks.device
    kind = torch.full((n_obs,), -1, dtype=torch.int64, device=device)
    rows_t = torch.as_tensor(rows, device=device)
    kind[rows_t] = torch.arange(len(rows), device=device) % masks.shape[0]

    def planted(idx):
        ll = log_lik_fn(idx)
        kd = kind[idx]
        hit = (kd >= 0)[:, None] & masks[kd.clamp_min(0)]
        return torch.where(hit, values[kd.clamp_min(0)].to(ll.dtype), ll)

    return planted


def cpu_loo_rows(pl, rows_host, reff: float):
    """The port's float32 ``loo_streaming`` on the CPU over host rows."""
    import torch

    rows_cpu = torch.from_numpy(rows_host)
    return on_cpu(pl, lambda: pl.loo_streaming(
        lambda idx: rows_cpu[idx], rows_cpu.shape[0], rows_cpu.shape[1], reff=reff,
        dtype="float32", pointwise=True))


def rows_close(got_e, got_k, want_e, want_k) -> tuple:
    """(ok, max |d loo_i|, max |d k|): loo_i within rtol/atol 1e-5 and k
    within 1e-3 (phase 2's float32 envelope against the plain scorer), NaN
    and +-inf exactly where the other has them."""
    import numpy as np

    ok = (np.allclose(got_e, want_e, rtol=1e-5, atol=1e-5, equal_nan=True)
          and np.allclose(got_k, want_k, rtol=0, atol=1e-3, equal_nan=True))
    fin = np.isfinite(got_e) & np.isfinite(want_e)
    fin_k = np.isfinite(got_k) & np.isfinite(want_k)
    d_e = float(np.abs(got_e - want_e)[fin].max(initial=0.0))
    d_k = float(np.abs(got_k - want_k)[fin_k].max(initial=0.0))
    return ok, d_e, d_k


def phase_edge(pl, smi: str, kernels: dict, model, reff: float, phase5: dict,
               device: str = "cuda", sizes: dict | None = None) -> None:
    """Phase 14: edge rows.  (a) kernels A-D against their plain versions on
    rows of NaN, +-inf, subnormals, +-FLT_MAX and +-0.0 at the k-th place
    (131,072 x 4,000; 4,096 x 32,768; phase 2b's 80,000 draws, a part and
    the merge, and the multipass split against one pass); (b) phase 5's
    ``loo_streaming`` with NaN, +inf and -inf draws planted in 384 rows,
    held to the port on the CPU over the planted rows and 3,712 clean ones,
    every other row equal to phase 5's bit for bit, and the float64 scorer
    on the same sampled rows against the CPU; (c) the same rows, on
    phase 6's 262,144-row cut, through ``loo_from_file``,
    ``loo_compare_streaming``, float32 ``loo()``, ``loo_group`` and
    ``loo_subsample``, each a launch window of its own.  ``device`` and
    ``sizes`` let the phase be rehearsed at a small size on the CPU."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pyloo_tpu_torch.ops import topk
    from pyloo_tpu_torch.ops.psis import tail_length
    from pyloo_tpu_torch.parallel.sharding import chunk_rows
    from pyloo_tpu_torch.streaming._chunks import resolve_chunk
    from bench_torch import model as bench_model

    z = dict(wide=(131_072, 4_000), deep=(4_096, 32_768), multi=(8_192, 80_000),
             multi_rows=1_024, n_cut=262_144, n_sample=3_712, planted=(384, 1_000, 641))
    z.update(sizes or {})
    print(f"phase 14: edge rows ({smi})", flush=True)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(14)

    # (a) kernels A-D on edge rows, outside the main-path windows
    zero_counts()
    calls = {"A": 0, "B": 0, "C": 0, "D": 0}
    # the PSIS tail's k at each width, and k = 256 (C and D's largest) at 32,768
    deep_k = tail_length(z["deep"][1]) + 1
    for (rows, s), k in ((z["wide"], tail_length(z["wide"][1]) + 1), (z["deep"], deep_k),
                         (z["deep"], 256)):
        x, names = edge_rows(rows, s, k, gen, device)
        if s == z["wide"][1]:
            print(f"  rows  {len(names)} edge kinds first: " + "; ".join(names), flush=True)
        hold_edge(kernels, x, k, f"edge rows ({rows}, {s})", bitonic=k <= 256)
        for name in "AB" + ("CD" if k <= 256 else ""):
            calls[name] += 1
        del x
    rows, s = z["multi"]
    k = tail_length(s) + 1
    parts = topk.multipass_parts(s, k)
    part_s = -(-s // parts)
    x, _ = edge_rows(rows, s, k, gen, device)
    hold_edge(kernels, x[:, part_s : 2 * part_s], k,
              f"edge rows, part ({rows}, {part_s}) at column {part_s}", bitonic=False)
    merge, _ = edge_rows(rows, parts * k, k, gen, device)
    hold_edge(kernels, merge, k, f"edge rows, merge ({rows}, {parts * k})", bitonic=False)
    calls["A"] += 2
    calls["B"] += 2
    del merge
    x = x[: z["multi_rows"]]
    got = topk.loo_prepass_multi(x, k, parts)
    want = topk.loo_prepass_plain(x, k)  # one pass over the whole row
    calls["A"] += parts
    calls["B"] += 1
    torch.cuda.synchronize()
    # the merge sums the non-tail mass in the log domain: where one pass's
    # exp-domain sum underflows to 0 (log -inf), the merge keeps the log of
    # a mass below float32's least normal (pyloo_tpu flushes it: ROADMAP
    # Queue 3 item 5); elsewhere the two agree as on clean rows
    deep = torch.isneginf(want[2]) & (got[2] < math.log(torch.finfo(torch.float32).tiny))
    ntl = torch.where(deep, want[2], got[2])
    ok = (torch.allclose(got[0], want[0], rtol=2e-6, atol=2e-5, equal_nan=True)
          and nan_equal(got[1], want[1])
          and torch.allclose(ntl, want[2], rtol=2e-6, atol=1e-6, equal_nan=True)
          and torch.allclose(got[3], want[3], rtol=2e-6, atol=1e-6, equal_nan=True))
    check(ok, f"kernel A multipass on edge rows ({z['multi_rows']}, {s}) k={k}, {parts} parts +"
          f" kernel B merge, against one pass: vals (rtol 2e-6, atol 2e-5), C equal, log_ntl and"
          f" log_sum_ll (rtol 2e-6, atol 1e-6), NaN matching NaN; {int(deep.sum())} rows whose"
          f" non-tail mass one pass flushes to 0 and the merge keeps below 1e-38")
    del x, got, want
    launched = read_counts(main_path=False)
    check(launched == {**calls, "E": 0, "F": 0},
          f"14a launches: A {launched['A']}, B {launched['B']}, C {launched['C']},"
          f" D {launched['D']} (the holds' calls: {calls})")

    # (b) loo_streaming at full width with planted rows
    xw, _, beta = model
    n_obs, s = xw.shape[0], beta.shape[0] * beta.shape[1]
    masks, values, kinds = plant_patterns(s, device)
    planted = planted_rows(n_obs, z["n_cut"], *z["planted"])
    clean_fn = bench_model.log_lik_fn(model)
    log_lik_fn = planted_chunks(clean_fn, n_obs, planted, masks, values)
    chunk, n_chunks = resolve_chunk(None, n_obs, s, torch.float32)
    print(f"phase 14b: loo_streaming float32 at {n_obs} x {s}, {len(planted)} planted rows"
          f" ({len(kinds)} kinds: " + "; ".join(kinds) + ")", flush=True)
    pl.rcParams["device.device"] = device
    pl.rcParams["device.precision"] = "float32"
    timings: dict = {}
    res = timed_call("loo_streaming (planted rows)", lambda: pl.loo_streaming(
        log_lik_fn, n_obs, s, reff=reff, dtype="float32", pointwise=True), timings)
    got = timings["loo_streaming (planted rows)"]["launches"]
    e, k = res.loo_i.values, res.pareto_k.values
    clean = np.ones(n_obs, bool)
    clean[planted] = False
    e5, k5 = phase5["loo_i"], phase5["pareto_k"]
    same_clean = (np.array_equal(e[clean], e5[clean], equal_nan=True)
                  and np.array_equal(k[clean], k5[clean], equal_nan=True))
    check(got["A"] == n_chunks and got["B"] == got["C"] == got["D"] == 0 and same_clean,
          f"kernel A launched {got['A']} times for {n_chunks} chunks; the {clean.sum()} clean"
          f" rows' loo_i and k equal phase 5's bit for bit"
          f" ({int((e[clean] != e5[clean]).sum())} loo_i differ)")
    sample = np.union1d(planted, np.arange(37, z["n_cut"], 70)[: z["n_sample"]])
    idx = torch.as_tensor(sample, device=device)
    rows_host = log_lik_fn(idx).cpu().numpy()
    cpu = cpu_loo_rows(pl, rows_host, reff)
    ok, d_e, d_k = rows_close(e[sample], k[sample], cpu.loo_i.values, cpu.pareto_k.values)
    pe, pk = e[planted], k[planted]
    check(ok and np.isnan(res["elpd_loo"]) and np.isnan(cpu["elpd_loo"]),
          f"the {len(planted)} planted and {len(sample) - len(planted)} clean rows against the"
          f" port on the CPU: max |d loo_i| {d_e:.3g}, max |d k| {d_k:.3g} where finite, NaN and"
          f" +-inf alike; planted loo_i NaN {int(np.isnan(pe).sum())}, +inf"
          f" {int(np.isposinf(pe).sum())}, -inf {int(np.isneginf(pe).sum())}, k inf"
          f" {int(np.isinf(pk).sum())}; elpd_loo NaN on the card and on the CPU's rows")
    for j, name in enumerate(kinds):
        r = planted[j]
        print(f"  row   {r} ({name}): loo_i {e[r]!r}, k {k[r]!r}", flush=True)
    # the float64 scorer (torch.topk, no kernel) on the same rows
    rows64 = torch.from_numpy(rows_host.astype(np.float64))
    card64 = rows64.to(device)
    zero_counts()
    got64 = pl.loo_streaming(lambda i: card64[i], len(sample), s, reff=reff, dtype="float64",
                             pointwise=True)
    launched = read_counts(main_path=False)
    cpu64 = on_cpu(pl, lambda: pl.loo_streaming(lambda i: rows64[i], len(sample), s, reff=reff,
                                                dtype="float64", pointwise=True))
    e64, k64 = got64.loo_i.values, got64.pareto_k.values
    ok = (np.allclose(e64, cpu64.loo_i.values, rtol=1e-10, atol=1e-10, equal_nan=True)
          and np.allclose(k64, cpu64.pareto_k.values, rtol=1e-10, atol=1e-10, equal_nan=True))
    check(ok and not any(launched.values()) and np.isnan(e64[np.isin(sample, planted)]).any(),
          f"float64 loo_streaming of the same {len(sample)} rows on the card against the CPU"
          f" within 1e-10, NaN and +-inf alike (loo_i NaN on {int(np.isnan(e64).sum())} rows);"
          f" no kernel launched ({launched})")

    # (c) the planted rows on phase 6's cut, through the other entry points
    n_cut = z["n_cut"]
    print(f"phase 14c: the planted rows on the first {n_cut} rows through loo_from_file,"
          f" loo_compare_streaming, loo(), loo_group and loo_subsample", flush=True)
    chains, draws = beta.shape[0], beta.shape[1]
    cut_host = np.empty((chains, draws, n_cut), np.float32)  # loo()'s (chain, draw, obs)
    tmp = tempfile.mkdtemp(prefix="pyloo_edge_")
    try:
        path = os.path.join(tmp, "log_lik.npy")
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32, shape=(n_cut, s))
        step = 50_000
        for start in range(0, n_cut, step):
            n = min(step, n_cut - start)
            block = log_lik_fn(torch.arange(start, start + n, device=device)).cpu().numpy()
            mm[start : start + n] = block
            cut_host[:, :, start : start + n] = block.T.reshape(chains, draws, n)
        mm.flush()
        del mm, block
        chunk_c, n_chunks_c = resolve_chunk(None, n_cut, s, torch.float32)
        out = timed_call("loo_from_file (planted rows)", lambda: pl.loo_from_file(
            path, native=True, reff=reff, dtype="float32", pointwise=True), timings)
        got = timings["loo_from_file (planted rows)"]["launches"]
        check(got["A"] == n_chunks_c and got["B"] == got["C"] == got["D"] == 0
              and np.array_equal(out.loo_i.values, e[:n_cut], equal_nan=True)
              and np.array_equal(out.pareto_k.values, k[:n_cut], equal_nan=True),
              f"loo_from_file: kernel A {got['A']} ({n_chunks_c} chunks); loo_i and k equal 14b's"
              f" on the same rows bit for bit, NaN as NaN")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    models = {"planted": log_lik_fn, "clean": clean_fn}
    table = timed_call("loo_compare_streaming (planted, clean)", lambda: pl.loo_compare_streaming(
        models, n_cut, s, reff=reff, dtype="float32"), timings)
    got = timings["loo_compare_streaming (planted, clean)"]["launches"]
    elpd = dict(zip(table.index, table["elpd_loo"]))
    want_clean = float(np.sum(e5[:n_cut], dtype=np.float64))
    sub_gen = {name: (lambda fn: (lambda i: fn(idx[i])))(fn) for name, fn in models.items()}
    card_sub = pl.loo_compare_streaming(sub_gen, len(sample), s, reff=reff, dtype="float32")
    cpu_rows = {name: torch.from_numpy(fn(idx).cpu().numpy()) for name, fn in models.items()}
    cpu_sub = on_cpu(pl, lambda: pl.loo_compare_streaming(
        {name: (lambda t: (lambda i: t[i]))(t) for name, t in cpu_rows.items()}, len(sample), s,
        reff=reff, dtype="float32"))
    same_table = card_sub.index == cpu_sub.index and all(
        np.allclose(np.asarray(card_sub[c], float), np.asarray(cpu_sub[c], float), rtol=1e-5,
                    atol=1e-5, equal_nan=True)
        for c in card_sub.columns if np.asarray(card_sub[c]).dtype.kind == "f")
    check(got["A"] == 2 * n_chunks_c and np.isnan(elpd["planted"])
          and math.isclose(elpd["clean"], want_clean, rel_tol=1e-9) and same_table,
          f"loo_compare_streaming: kernel A {got['A']} (2 x {n_chunks_c}); elpd_loo planted"
          f" {elpd['planted']!r}, clean {elpd['clean']:.4f} (the sum of phase 5's first {n_cut}"
          f" loo_i: {want_clean:.4f}); the table over the {len(sample)} sampled rows against the"
          f" CPU (rtol/atol 1e-5, NaN as NaN; ranks {card_sub.index})")

    idata = pl.from_dict(posterior={"beta": beta.cpu().numpy()}, log_likelihood={"y": cut_host})
    with warnings_quiet():
        stored = timed_call("loo() float32 (planted rows)",
                            lambda: pl.loo(idata, pointwise=True), timings)
        sub = pl.from_dict(posterior={"beta": beta.cpu().numpy()},
                           log_likelihood={"y": np.ascontiguousarray(cut_host[:, :, sample])})
        stored_cpu = on_cpu(pl, lambda: pl.loo(sub, pointwise=True))
    got = timings["loo() float32 (planted rows)"]["launches"]
    loo_chunks = -(-n_cut // chunk_rows(s, chains))
    ok, d_e, d_k = rows_close(stored.loo_i.values[sample], stored.pareto_k.values[sample],
                              stored_cpu.loo_i.values, stored_cpu.pareto_k.values)
    check(got["A"] == loo_chunks and got["B"] == got["C"] == got["D"] == 0 and ok,
          f"loo() float32 (NaN cleaned to -1e10, +-inf kept): kernel A {got['A']}"
          f" ({loo_chunks} chunks); the"
          f" {len(sample)} sampled rows against loo() on the CPU: max |d loo_i| {d_e:.3g},"
          f" max |d k| {d_k:.3g} where finite, NaN and +-inf alike")

    groups = np.arange(n_cut) * 1_000 // n_cut  # 1,000 groups of consecutive rows
    with warnings_quiet():
        logo = timed_call("loo_group (planted rows, 1,000 groups)",
                          lambda: pl.loo_group(idata, groups, pointwise=True), timings)
    got = timings["loo_group (planted rows, 1,000 groups)"]["launches"]
    picked = np.union1d(np.unique(groups[planted]), np.arange(0, 1_000, 61))
    in_picked = np.isin(groups, picked)
    sub = pl.from_dict(posterior={"beta": beta.cpu().numpy()},
                       log_likelihood={"y": np.ascontiguousarray(cut_host[:, :, in_picked])})
    with warnings_quiet():
        logo_cpu = on_cpu(pl, lambda: pl.loo_group(sub, groups[in_picked], pointwise=True))
    g_e, g_k = logo.logo_i.values[picked], np.asarray(logo.pareto_k)[picked]
    c_e, c_k = logo_cpu.logo_i.values, np.asarray(logo_cpu.pareto_k)
    ok = (np.allclose(g_e, c_e, rtol=1e-4, equal_nan=True)
          and np.allclose(g_k, c_k, rtol=0, atol=5e-3, equal_nan=True))
    check(got["B"] == 1 and got["A"] == got["C"] == got["D"] == 0 and ok,
          f"loo_group: kernel B {got['B']}; the {len(picked)} groups that hold a planted row or"
          f" every 61st against the CPU (logo_i rtol 1e-4, k atol 5e-3, NaN as NaN): logo_i NaN"
          f" {int(np.isnan(g_e).sum())}")

    observations = np.union1d(planted, np.arange(11, n_cut, 71))[:4_000]
    with warnings_quiet():
        sampled = timed_call("loo_subsample (planted rows)", lambda: pl.loo_subsample(
            idata, observations=observations, seed=14, pointwise=True), timings)
    got = timings["loo_subsample (planted rows)"]["launches"]
    rows_s = sampled.estimates.indices.idx
    s_e = sampled.loo_i.values[rows_s]
    ref = stored.loo_i.values[rows_s]
    check(got["B"] == 1 and got["A"] == got["C"] == got["D"] == 0
          and np.array_equal(np.sort(rows_s), observations)
          and np.allclose(s_e, ref, rtol=1e-4, atol=1e-4, equal_nan=True),
          f"loo_subsample: kernel B {got['B']}; its {len(rows_s)} rows' loo_i against loo()'s on"
          f" the card (rtol/atol 1e-4, NaN as NaN; planted rows {int(np.isin(rows_s, planted).sum())})")
    del idata, cut_host
    print(f"  time  phase 14 {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_edge_alone() -> int:
    """Phase 14 alone, with the set-up it takes from phases 0 and 5;
    returns the failures' count.  On a machine with a card, from the root
    of the repository::

        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.phase_edge_alone())"
    """
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pyloo_tpu_torch as pl
    from pyloo_tpu_torch import _build
    from pyloo_tpu_torch._common import compute_reff
    from bench_torch import model as bench_model

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.load()
    pl.rcParams["device.device"] = "cuda"
    model = bench_model.logistic_model(1_000_000, 4, 1_000, 7, "cuda")
    xw, _, beta = model
    s = beta.shape[0] * beta.shape[1]
    reff = compute_reff(pl.from_dict(posterior={"beta": beta.cpu().numpy()}), None, s)
    res = pl.loo_streaming(bench_model.log_lik_fn(model), xw.shape[0], s, reff=reff,
                           dtype="float32", pointwise=True)
    phase5 = {"loo_i": res.loo_i.values, "pareto_k": res.pareto_k.values}
    kernels = {key: {"max_abs_err": 0.0} for key in KERNEL_COUNTERS}
    phase_edge(pl, smi, kernels, model, reff, phase5)
    print(f"chip_smoke: {len(_FAILURES)} check(s) failed", flush=True)
    return len(_FAILURES)


def phase_mesh_alone() -> int:
    """Phase 13 alone, with the set-up it takes from phases 0, 5 and 6;
    returns the failures' count.  On a
    machine with a card, from the root of the repository::

        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.phase_mesh_alone())"
    """
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pyloo_tpu_torch as pl
    from pyloo_tpu_torch import _build
    from pyloo_tpu_torch._common import compute_reff
    from bench_torch import model as bench_model

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.load()
    pl.rcParams["device.device"] = "cuda"
    model = bench_model.logistic_model(1_000_000, 4, 1_000, 7, "cuda")
    xw, yw, beta = model
    s = beta.shape[0] * beta.shape[1]
    reff = compute_reff(pl.from_dict(posterior={"beta": beta.cpu().numpy()}), None, s)
    res = pl.loo_streaming(bench_model.log_lik_fn(model), xw.shape[0], s, reff=reff,
                           dtype="float32", pointwise=True)
    phase5 = {"digest": result_digest(res), "elpd_loo": res["elpd_loo"]}
    zero = xw.new_zeros(())
    ll_cut = np.empty((beta.shape[0], beta.shape[1], 262_144), np.float32)
    for c in range(beta.shape[0]):  # the rows logistic_log_lik makes, phase 6's cut
        eta = beta[c] @ xw[:262_144].T
        torch.from_numpy(ll_cut[c]).copy_(yw[:262_144] * eta - torch.logaddexp(eta, zero))
        del eta
    phase_mesh(pl, smi, model, reff, phase5, ll_cut)
    print(f"chip_smoke: {len(_FAILURES)} check(s) failed", flush=True)
    return len(_FAILURES)


def phase_bench(smi: str) -> None:
    """Phase 15: each cell of ``bench_torch`` once, through its functions
    (one timed call, no trace), its gate applied, its launches counted."""
    import torch

    from bench_torch import bench

    print(f"phase 15: the benchmark's cells, once each ({smi})", flush=True)
    for name in (bench.STREAMING_CELL, bench.HOST_CELL):
        torch.cuda.empty_cache()
        zero_counts()
        t = time.perf_counter()
        res = bench.run_cell(name, bench.SEED, "cuda", repeats=1, profile=False)
        wall = time.perf_counter() - t
        got = read_counts()
        per_call = res["metrics"]["kernel_a_launches_per_call"]["value"]
        want = res["shape"].get("n_chunks", 0)
        check(per_call == want and (got["A"] > 0) == (want > 0)
              and got["B"] == got["C"] == got["D"] == got["E"] == 0,
              f"15 {name}: kernel A launched {per_call:g} times a call ({want} chunks),"
              f" {got['A']} in the cell's window (warmup, first and timed call); B-E {got['B']},"
              f" {got['C']}, {got['D']}, {got['E']}")
        g = res["gate"]
        check(g["passed"], f"15 {name}: {g['rows']} rows against the float64 reference, max |d"
              f" loo_i| {g['max_abs_err_loo_i']:.3g} (rtol/atol {g['tol_loo_i']:g}), max |d k|"
              f" {g['max_abs_err_k']:.3g} ({g['tol_k']:g}); {g['tie_rows']} cutoff-tie rows,"
              f" max |d k| {g['max_abs_err_k_tie_rows']:.3g} ({g['tol_tie_rows']:g})")
        m = res["metrics"]
        print(f"  time  15 {name}: one call {m['wall_s']['median']:.3f} s"
              f" ({m['obs_per_sec']['value']:.0f} obs/s), peak device memory"
              f" {m['peak_device_gb']['value']:.2f} GB; the cell {wall:.1f} s with its set-up"
              f" ({', '.join(f'{k} {v:.2f}' for k, v in res['setup'].items() if k.endswith('_s'))})"
              f" on {smi}", flush=True)


# phase 16: the fuzz's trials a mode (the modes' shares of it, as the
# script takes them: streaming, fast32 and subsample this many, nonfactor
# and mesh 4, lfo 5, mm 4) and its seed
TOOL_TRIALS = 8
TOOL_SEED = 20260818


def tool_coverage(records) -> list:
    """What ``validate_kernels``' records lack of the card's envelope, per
    kernel A-D: a case at S < 32, at B < 4, at a view's unaligned column, at
    each sort tier P its k takes, and in each of the adversarial, tie,
    overflow and edge families."""
    missing = []
    for letter, max_k in (("A", 1_024), ("B", 1_024), ("C", 256), ("D", 256)):
        mine = [r for r in records if r["kernel"] == letter]
        tiers = {max(32, 1 << (r["k"] - 1).bit_length()) for r in mine}
        wants = {"S < 32": any(r["s"] < 32 for r in mine),
                 "B < 4": any(r["b"] < 4 for r in mine),
                 "an unaligned view": any(r["col"] % 4 for r in mine),
                 "every sort tier": tiers == {32 << i for i in range(6) if 32 << i <= max_k}}
        for family in ("adversarial", "ties at k", "overflow", "edge"):
            wants[family] = any(r["family"] == family for r in mine)
        missing += [f"{letter}: {what}" for what, ok in wants.items() if not ok]
    return missing


def phase_tools(smi: str) -> None:
    """Phase 16: the repo's two verification harnesses, ported, in this
    process: every section of ``pyloo_tpu_torch.tools.validate_kernels``
    (kernels A-D over their envelope, the float64 programs against their
    oracles) and every mode of ``pyloo_tpu_torch.tools.fuzz_differential``
    at ``TOOL_TRIALS`` and ``TOOL_SEED``, each trial also held to the CPU.
    Their launches are counted outside the main-path windows, as phase 14a's."""
    import torch

    from pyloo_tpu_torch.tools import fuzz_differential, validate_kernels

    print(f"phase 16: the verification tools, validate_kernels and fuzz_differential ({smi})",
          flush=True)
    t_phase = time.perf_counter()
    device = torch.device("cuda", torch.cuda.current_device())
    zero_counts()
    run = validate_kernels.Run(device, TOOL_SEED)
    t = time.perf_counter()
    with warnings_quiet():
        ok = validate_kernels.run_sections(run, validate_kernels.SECTIONS)
    out = os.path.join("build", "validate_kernels.json")
    validate_kernels.write_records(run, out, ok)
    failed = [r for r in run.records if not r["pass"]]
    check(ok and not failed and run.platform == "gpu",
          f"16 validate_kernels: {len(run.records)} cases in {len(validate_kernels.SECTIONS)}"
          f" sections, {len(failed)} failed, on {run.card} ({time.perf_counter() - t:.1f} s;"
          f" records in {out})")
    missing = tool_coverage(run.records)
    check(not missing, "16 validate_kernels covers, for each of kernels A-D, S < 32, B < 4, an"
          " unaligned view, every sort tier and the adversarial, tie, overflow and edge"
          " families" + (f"; missing: {', '.join(missing)}" if missing else ""))
    n_overflow = sum(r.get("overflow_rows_kernel") or 0 for r in run.records)
    print(f"  rows  kernels A and B narrowed {n_overflow} rows by a further digit in the tool's"
          " cases, each case equal to the plain scheme's count", flush=True)
    for mode in fuzz_differential.MODES:
        trials = fuzz_differential.trials_of(mode, TOOL_TRIALS)
        res = fuzz_differential.fuzz_mode(mode, trials, TOOL_SEED, device)
        check(res["failures"] == 0 and res["trials"] == trials,
              f"16 fuzz {mode}: {res['trials']} trials (seed {TOOL_SEED}), {res['failures']}"
              f" failed, each held to the CPU ({res['seconds']:.1f} s)")
    got = read_counts(main_path=False)
    print(f"  time  phase 16 {time.perf_counter() - t_phase:.1f} s on {smi}; launches outside the"
          f" main-path windows: A {got['A']}, B {got['B']}, C {got['C']}, D {got['D']}",
          flush=True)


@contextlib.contextmanager
def warnings_quiet():
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def phase_baseline(pl):
    print("phase 4: loo(centered_eight) against the published baseline", flush=True)
    want = {"elpd_loo": -30.7807, "se": 1.3435, "p_loo": 0.9472, "looic": 61.5613}
    for precision in ("float64", "float32"):
        pl.rcParams["device.precision"] = precision
        res = pl.loo(pl.load_example_data("centered_eight"))
        got = {key: res[key] for key in want}
        if precision == "float64":
            ok = all(round(got[key], 4) == value for key, value in want.items())
            tol = "to 4 decimals"
        else:
            ok = all(abs(got[key] - value) <= 1e-3 for key, value in want.items())
            tol = "within 1e-3"
        check(ok, f"{precision}: " + ", ".join(f"{k} {v:.4f}" for k, v in got.items())
              + f" ({tol})")
    pl.rcParams["device.precision"] = "float64"


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import pyloo_tpu_torch as pl
    except ImportError as err:
        print(f"chip_smoke: the pyloo_tpu_torch package is missing: {err}", file=sys.stderr)
        return 1
    from pyloo_tpu_torch import _build
    from pyloo_tpu_torch._common import compute_reff
    from pyloo_tpu_torch.ops.psis import tail_length

    torch.backends.cuda.matmul.allow_tf32 = False  # the data generator's matmul in full f32
    torch.backends.cudnn.allow_tf32 = False

    print("phase 0: device and build", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" {torch.cuda.get_device_name(0)}", flush=True)
    try:
        t = time.perf_counter()
        import scipy
        import scipy.optimize  # noqa: F401  (imported here so phase 7 times SLSQP alone)

        print(f"  scipy {scipy.__version__} (loo_compare's SLSQP stacking imports it;"
              f" scipy.optimize imported in {time.perf_counter() - t:.2f} s)", flush=True)
    except ImportError:
        print("  scipy is missing: loo_compare's SLSQP stacking cannot run", flush=True)
    for name, user in (("h5py", "from_netcdf / save_netcdf"), ("matplotlib", "the plots")):
        try:
            module = __import__(name)
            print(f"  {name} {module.__version__} ({user} import it; no phase uses it)", flush=True)
        except ImportError:
            print(f"  {name} is missing: {user} cannot run here (no phase uses it)", flush=True)
    t = time.perf_counter()
    _build.load()
    print(f"  build {time.perf_counter() - t:.2f} s into {_build.BUILD_DIR}", flush=True)
    # ptxas, per kernel: "Function properties for NAME", its spill line, its registers
    function, spill, bitonic_spills = "", "", []
    for line in _build.build_log.splitlines():
        if "Function properties for" in line:
            function = line.split("Function properties for")[-1].strip()
        elif "bytes spill" in line:
            spill = line.strip()
            if "topk_bitonic_kernel" in function:
                bitonic_spills.append(spill)
        elif "registers" in line:
            print("  ptxas" + line.split("ptxas info    :")[-1] + "; " + spill, flush=True)
    check(len(bitonic_spills) == 4 and all(
        "0 bytes spill stores, 0 bytes spill loads" in line for line in bitonic_spills),
        f"ptxas reports 0 bytes of spill for kernels C and D ({len(bitonic_spills)}"
        f" instantiations: C and D, with 16-byte and with 4-byte loads)")

    prepass, bitonic = "pyloo_tpu_torch/csrc/topk_prepass.cu", "pyloo_tpu_torch/csrc/topk_bitonic.cu"

    pallas = "pyloo_tpu/ops/pallas_topk.py"

    def entry(name, source, replaces):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": 0, "max_abs_err": 0.0}

    kernels = {
        "loo_prepass": entry("loo_prepass (kernel A, fused PSIS prepass)", prepass,
                             f"{pallas}:314"),
        "topk_desc": entry("topk_desc variant='roll' (kernel B, exact top-k)", prepass,
                           f"{pallas}:212"),
        "topk_reshape": entry("topk_desc variant='reshape' (kernel C, bitonic top-k)",
                              bitonic, f"{pallas}:176"),
        "topk_natural": entry("topk_desc variant='natural' (kernel D, bitonic top-k)",
                              bitonic, f"{pallas}:606"),
        "topk_profile": entry("profile_topk_desc (kernel E, profiling harness over kernel B)",
                              "pyloo_tpu_torch/ops/topk_profile.py",
                              "scripts/profile_pallas_topk.py:76"),
        "psis_tail_fit": entry("psis_tail_fit (kernel F, float32 tail fit, smoothing and elpd)",
                               "pyloo_tpu_torch/csrc/psis_tail_fit.cu",
                               "none: pyloo_tpu/ops/loo_kernels.py's _psis_tail_scores, fused"
                               " by XLA"),
    }
    phase_kernels(kernels, tail_length)
    phase_variants(kernels)
    phase_fit(kernels["psis_tail_fit"], tail_length)
    ll_host, beta, model, res32, _ = phase_main_path(pl, kernels)
    reff = compute_reff(pl.from_dict(posterior={"beta": beta}), None, beta.shape[0] * beta.shape[1])
    res64 = phase_float64(pl, ll_host, beta, res32)
    phase_baseline(pl)
    phase5 = phase_streaming(pl, ll_host, model, reff, res32, res64)
    del res64
    waic32 = phase_weights(pl, ll_host, beta, res32, smi)
    phase_scoring(pl, ll_host, beta, model, reff, res32, phase5, waic32, smi)
    phase_disk(pl, ll_host, model, reff, phase5, waic32, smi)
    del waic32
    phase_subsample(pl, ll_host, beta, model, reff, res32, phase5, smi)
    ll_wells = np.ascontiguousarray(ll_host[:, :, :3_020])  # phase 12b's Stan CSV files
    ll_cut = np.ascontiguousarray(ll_host[:, :, :262_144])  # phase 13's loo() rows
    del ll_host
    phase_refits(pl, smi)
    phase_fits(pl, smi)
    phase_first_use(pl, smi, model, reff, phase5, ll_wells)
    phase_mesh(pl, smi, model, reff, phase5, ll_cut)
    del ll_cut
    phase_edge(pl, smi, kernels, model, reff, phase5)
    del model
    phase_bench(smi)
    phase_tools(smi)

    for key, kern in kernels.items():
        kern["launches"] = PATH_LAUNCHES[KERNEL_COUNTERS[key]]
        check(kern["launches"] > 0, f"{key} ran on the main paths ({kern['launches']} launches)")
        if key in ("topk_desc", "topk_reshape", "topk_natural"):
            kern["torch_topk_ms"] = kern["library_ms"]
    if _FAILURES:
        print(f"chip_smoke: {len(_FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "torch_topk_ms", "by_shape", "splits")
    print(json.dumps({"kernels": [
        {key: kern[key] for key in keys if key in kern} for kern in kernels.values()
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
