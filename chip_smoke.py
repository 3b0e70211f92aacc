"""Drive pyloo_tpu_torch's main path once on one NVIDIA GPU and check it.

Usage, from the root of the repository, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases:

0. the card (``nvidia-smi`` name and power limit) and the kernel build;
1. each CUDA kernel against its plain PyTorch version at the shapes the main
   path gives it, with their times at 131,072 x 4,000;
2. ``loo()`` in float32 at 1,000,000 observations x 4,000 draws (a logistic
   regression with 32 features, made on the card from a seed), through the
   fused prepass kernel, checked against the plain scorer on the card; then
   ``loo()`` at 80,000 draws, through the multipass split and its top-k
   merge;
3. the default float64 path on the first 250,000 observations, held to the
   float32 results;
4. ``loo(centered_eight)`` against the published baseline.

Prints one JSON line of kernel results and, last, ``{"ok": true, "device":
...}``.  Exits non-zero, printing no result, when there is no CUDA device,
when the package is missing, or when any check fails.
"""

from __future__ import annotations

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


def smoke_rows(b: int, s: int, gen):
    """x = -log_lik rows: normal, a full-row tie, some -inf, a heavy tail."""
    import torch

    ll = torch.randn(b, s, device="cuda", generator=gen) * 0.8 - 1.0
    ll[0] = -0.25  # full-row tie: x = 0.25
    ll[1, ::7] = math.inf  # x = -inf entries, not the whole row
    z = torch.randn(4, s, device="cuda", generator=gen)
    t3 = z[0] / torch.sqrt(z[1:].square().sum(dim=0) / 3.0)  # Student-t, 3 dof
    ll[2] = 2.0 * t3 - 1.0  # heavy tail
    return (-ll).contiguous()


def phase_kernels(kernels: dict, tail_length) -> None:
    import torch

    from pyloo_tpu_torch.ops import topk

    print("phase 1: kernels against their plain versions", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    a, b = kernels["loo_prepass"], kernels["topk_desc"]
    for rows, s in [(131_072, 4_000), (16_384, 16_000), (4_096, 32_768)]:
        k = tail_length(s) + 1
        x = smoke_rows(rows, s, gen)
        got = topk.loo_prepass(x, k)
        want = topk.loo_prepass_plain(x, k)
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        err = max(float((g - w).abs().max()) for g, w in zip(got[2:], want[2:]))
        close = all(
            torch.allclose(g, w, rtol=2e-6, atol=1e-6) for g, w in zip(got[2:], want[2:])
        )
        a["max_abs_err"] = max(a["max_abs_err"], err)
        check(same and close, f"kernel A ({rows}, {s}) k={k}: vals, C bitwise;"
              f" log_ntl, log_sum_ll max |err| {err:.3g} (rtol 2e-6, atol 1e-6)")
        got_b = topk.topk_desc(x, k)
        want_b = topk.topk_desc_plain(x, k)
        torch.cuda.synchronize()
        b["max_abs_err"] = max(b["max_abs_err"], float((got_b - want_b).abs().nan_to_num().max()))
        check(torch.equal(got_b, want_b), f"kernel B ({rows}, {s}) k={k}: bitwise to torch.topk")
        if s == 4_000:
            for name, kern, plain in [
                ("loo_prepass", topk.loo_prepass, topk.loo_prepass_plain),
                ("topk_desc", topk.topk_desc, topk.topk_desc_plain),
            ]:
                kernels[name]["plain_ms"] = median_ms(lambda: plain(x, k))
                kernels[name]["ms"] = median_ms(lambda: kern(x, k))
                kernels[name]["plain_ms_after"] = median_ms(lambda: plain(x, k))
                print(f"  time  {name} ({rows}, {s}) k={k}: kernel"
                      f" {kernels[name]['ms']:.3f} ms, plain {kernels[name]['plain_ms']:.3f}"
                      f" / {kernels[name]['plain_ms_after']:.3f} ms (before / after)", flush=True)
        del x, got, want, got_b, want_b

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


def logistic_log_lik(n_obs: int, chains: int, draws: int, seed: int):
    """Host (chain, draw, obs) float32 log-likelihood of a logistic regression
    with 32 features, computed on the card; ``beta`` as its posterior."""
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    beta = 0.3 * torch.randn(chains, draws, 32, device="cuda", generator=gen)
    xw = 0.5 * torch.randn(n_obs, 32, device="cuda", generator=gen)
    yw = (torch.rand(n_obs, device="cuda", generator=gen) < 0.5).float()
    zero = xw.new_zeros(())
    ll = np.empty((chains, draws, n_obs), np.float32)
    for c in range(chains):
        eta = beta[c] @ xw.T  # (draws, obs), full float32 (no TF32)
        torch.from_numpy(ll[c]).copy_(yw * eta - torch.logaddexp(eta, zero))
        del eta
    return ll, beta.cpu().numpy()


def obs_major(ll_host, n_rows: int):
    """The (n_rows, S) matrix loo() builds, for the first n_rows observations."""
    import numpy as np
    import torch

    chains, draws, _ = ll_host.shape
    part = torch.from_numpy(np.ascontiguousarray(ll_host[:, :, :n_rows])).cuda()
    return part.reshape(chains * draws, n_rows).T.contiguous()


def run_loo(pl, idata, timed: dict):
    """``pl.loo`` with its scoring part (apply_rowwise) timed on the side."""
    import torch

    loo_mod = sys.modules["pyloo_tpu_torch.loo"]  # the package's `loo` is the function
    real = loo_mod.apply_rowwise

    def timed_apply(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        timed["scoring_s"] = time.perf_counter() - t
        return out

    loo_mod.apply_rowwise = timed_apply
    try:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = pl.loo(idata, pointwise=True)
        torch.cuda.synchronize()
        timed["wall_s"] = time.perf_counter() - t
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
    ll_host, beta = logistic_log_lik(n_obs, chains, draws, seed=7)
    print(f"  data  {ll_host.nbytes / 1e9:.1f} GB log-likelihood made in"
          f" {time.perf_counter() - t:.1f} s", flush=True)
    idata = pl.from_dict(posterior={"beta": beta}, log_likelihood={"y": ll_host})
    m_tail = tail_length(chains * draws, compute_reff(idata, None, chains * draws))
    pl.rcParams["device.device"] = "cuda"
    pl.rcParams["device.precision"] = "float32"

    # the main path's run: every launch counter from 0, read right after
    topk.loo_prepass.launches = 0
    topk.topk_desc.launches = 0
    timed: dict = {}
    res = run_loo(pl, idata, timed)
    launches_a, launches_b = topk.loo_prepass.launches, topk.topk_desc.launches
    n_chunks = -(-n_obs // chunk_rows(chains * draws, 4))
    check(launches_a == n_chunks and launches_b == 0,
          f"kernel A launched {launches_a} times for {n_chunks} chunks; kernel B {launches_b}")
    loo_i, khat = res.loo_i.values, res.pareto_k.values
    check(loo_i.shape == (n_obs,) and np.isfinite(loo_i).all() and np.isfinite(khat).all(),
          f"loo_i, pareto_k finite, shape {loo_i.shape}; elpd_loo {res['elpd_loo']:.6f},"
          f" {res.fast_path_degenerate} degenerate rows")
    print(f"  time  loo() {timed['wall_s']:.3f} s wall, scoring {timed['scoring_s']:.3f} s,"
          f" {n_obs / timed['wall_s']:.0f} obs/s; peak device memory"
          f" {timed['peak_gb']:.2f} GB", flush=True)

    # beyond one block's 32,768 draws: kernel A per part, kernel B in the merge
    print("phase 2b: loo() float32 at 8,192 x 80,000 (multipass)", flush=True)
    ll_wide, beta_wide = logistic_log_lik(8_192, 4, 20_000, seed=8)
    wide = pl.from_dict(posterior={"beta": beta_wide}, log_likelihood={"y": ll_wide})
    m_wide = tail_length(80_000, compute_reff(wide, None, 80_000))
    timed_wide: dict = {}
    res_wide = run_loo(pl, wide, timed_wide)
    wide_a = topk.loo_prepass.launches - launches_a
    wide_b = topk.topk_desc.launches - launches_b
    kernels["loo_prepass"]["launches"] = topk.loo_prepass.launches
    kernels["topk_desc"]["launches"] = topk.topk_desc.launches
    wide_chunks = -(-8_192 // chunk_rows(80_000, 4))
    parts = topk.multipass_parts(80_000, m_wide + 1)
    check(wide_a == parts * wide_chunks and wide_b == wide_chunks,
          f"kernel A launched {wide_a} times ({parts} parts x {wide_chunks} chunks);"
          f" kernel B {wide_b} times (one merge per chunk)")
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
        plain = loo_scores_psis_fast(x, m, route="torch")
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
    return ll_host, beta, res, timed


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
    res = run_loo(pl, idata, timed)
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
    t = time.perf_counter()
    _build.load()
    print(f"  build {time.perf_counter() - t:.2f} s into {_build.BUILD_DIR}", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line:
            print("  ptxas" + line.split("ptxas info    :")[-1], flush=True)

    source = "pyloo_tpu_torch/csrc/topk_prepass.cu"
    kernels = {
        "loo_prepass": {"name": "loo_prepass (kernel A, fused PSIS prepass)", "route": "cuda",
                        "source": source, "replaces": "pyloo_tpu/ops/pallas_topk.py:314",
                        "launches": 0, "max_abs_err": 0.0},
        "topk_desc": {"name": "topk_desc (kernel B, exact top-k)", "route": "cuda",
                      "source": source, "replaces": "pyloo_tpu/ops/pallas_topk.py:212",
                      "launches": 0, "max_abs_err": 0.0},
    }
    phase_kernels(kernels, tail_length)
    ll_host, beta, res32, _ = phase_main_path(pl, kernels)
    phase_float64(pl, ll_host, beta, res32)
    del ll_host
    phase_baseline(pl)

    for name in ("loo_prepass", "topk_desc"):
        check(kernels[name]["launches"] > 0, f"{name} ran on the main path")
    if _FAILURES:
        print(f"chip_smoke: {len(_FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [
        {key: kern[key] for key in ("name", "route", "source", "replaces", "launches",
                                    "max_abs_err", "ms", "plain_ms")}
        for kern in kernels.values()
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
