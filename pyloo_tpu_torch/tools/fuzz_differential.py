"""Randomised differential fuzz of the port's entry points, on the card.

Port of ``scripts/fuzz_differential.py``.  Every trial draws a random shape,
chunking, ``reff`` and log-likelihood family (:func:`gen_ll`: normal,
heavy-tailed t, exponential, rounded ties, constant rows, bimodal) from the
seed, as that script does, and holds the port's streamed or batched
surface to its in-memory or independent counterpart, in seven modes:

* ``streaming`` -- ``loo_streaming`` == ``loo`` (elpd 1e-9, loo_i 1e-8,
  pareto_k 1e-6 and its inf placement), ``psislw_compact().densify()`` ==
  ``psislw`` (1e-10), ``waic_streaming`` == ``waic`` (1e-9 / 1e-8),
  ``e_loo_streaming`` == ``e_loo`` (mean and sd, 1e-7),
  ``loo_group_streaming`` == ``loo_group`` (1e-9);
* ``nonfactor`` -- ``loo_nonfactor`` against brute-force conditional
  log-likelihoods and ``psislw`` (1e-6);
* ``fast32`` -- float32 ``loo_streaming`` (kernel A on the card) against
  float64 (elpd 2e-3 relative, k 0.08);
* ``subsample`` -- ``loo_subsample_streaming`` == ``loo_subsample`` on the
  same rows, each estimator (1e-8);
* ``mesh`` -- ``loo_streaming`` over a mesh == with none (1e-12 / 1e-11);
  over ``obs_mesh()`` with two cards or more, else four shards of the one
  device (``cuda:0`` or ``cpu``);
* ``lfo`` -- ``loo_lfo`` against a per-target oracle (``psislw`` of plain
  NumPy ratio sums, 1e-9);
* ``mm`` -- device-batched moment matching == the host loop on conjugate
  regressions with exact posterior draws (1e-8).

On the card each trial also runs on the CPU, and every float64 result is
held to the CPU's within :data:`CARD_CPU_TOL` (moment matching's pareto_k
within :data:`MM_K_TOL`, the mode's own bar); float32 results (``fast32``)
within the float32 envelope (:data:`F32_TOL_LOO_I`, :data:`F32_TOL_K`,
:data:`F32_TOL_TIE` for rows whose float32 tail differs from float64's by a
cutoff tie), and kernel A's route against the plain route
(``loo_scores_psis_fast(route="torch")``) on the card, within the same
envelope.

Run, from the root of the repository::

    python3 -m pyloo_tpu_torch.tools.fuzz_differential [trials] [seed] [mode]
        [--device cuda|cpu]

``trials`` defaults to 40 and ``seed`` to 20260818; ``mode`` is one of the
seven or ``all`` (default ``streaming``); the other modes take the script's
shares of ``trials`` (nonfactor and mesh a third, at least 4; lfo a half,
at least 5; mm a fifth, at least 4).  It runs on the card and exits 2 where
torch finds none; ``--device cpu`` runs it on the CPU alone.  Each mode
prints its trial count and failures; any failure exits 1.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
import warnings

import numpy as np
import torch

from ._harness import card_of, on_device, platform_of, resolve_device

MODES = ("streaming", "nonfactor", "fast32", "subsample", "mesh", "lfo", "mm")
DISTS = ("normal", "t", "exp", "ties", "const-rows", "bimodal")

# the card against the port on the CPU, same inputs (PERF.md section 2)
CARD_CPU_TOL = 1e-10  # float64, relative and absolute
# moment matching's pareto_k, card against CPU: the mode's own bar between
# its two paths.  The card's transformed draws differ from the CPU's in their
# last bits, and the Pareto fit amplifies that (the CPU's fit of the card's
# own log ratios gives the card's k: the mm_drift_probe tool, ROADMAP Queue 3
# item 45)
MM_K_TOL = 1e-8
F32_TOL_LOO_I = 1e-4  # float32 loo_i, relative to 1 + |loo_i|
F32_TOL_K = 2e-3  # float32 pareto_k, absolute
F32_TOL_TIE = 1e-2  # rows whose float32 tail differs by a cutoff tie (ROADMAP Queue 3 item 6)


def gen_ll(rng, dist, B, S):
    """A ``(B, S)`` float64 log-likelihood of one family (the script's draws)."""
    if dist == "normal":
        return rng.normal(-1, rng.uniform(0.1, 2), size=(B, S))
    if dist == "t":
        return -np.abs(rng.standard_t(df=rng.uniform(1.1, 5), size=(B, S)))
    if dist == "exp":
        return -rng.exponential(rng.uniform(0.5, 3), size=(B, S))
    if dist == "ties":
        return np.round(rng.normal(-1, 1, size=(B, S)), 1)
    if dist == "const-rows":
        ll = np.tile(rng.normal(-1, 1, size=(B, 1)), (1, S))
        ll[: B // 2] = rng.normal(-1, 1, size=(B // 2, S))
        return ll
    return np.where(
        rng.random((B, S)) < 0.5,
        rng.normal(-3, 0.3, size=(B, S)),
        rng.normal(-0.5, 0.3, size=(B, S)),
    )


def _rows_fn(ll: np.ndarray, device, dtype=torch.float64):
    """The generator contract: indices on the device -> their rows there."""
    rows = torch.as_tensor(ll, dtype=dtype, device=device)
    return lambda idx: rows[idx]


def _idata(ll: np.ndarray):
    from .. import from_dict

    return from_dict(log_likelihood={"obs": ll.T[None]})


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):  # before .values: a tensor has a method of that name
        v = v.detach().cpu().numpy()
    v = getattr(v, "values", v)
    return np.asarray(v, dtype=np.float64).ravel()


def held(got, want, rtol: float, atol: float, what: str, fails: list) -> None:
    """``got`` within ``atol + rtol |want|`` of ``want``, NaN matching NaN
    and an infinity itself; else a message in ``fails``."""
    g, w = _np(got), _np(want)
    if g.shape != w.shape:
        fails.append(f"{what}: shape {g.shape} against {w.shape}")
        return
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    with np.errstate(invalid="ignore"):
        close = np.abs(g - w) <= atol + rtol * np.abs(w)
    bad = ~(same | close)
    if bad.any():
        i = int(np.argmax(bad))
        fails.append(f"{what}: {int(bad.sum())} of {g.size} differ beyond rtol {rtol:g},"
                     f" atol {atol:g}; first at {i}: {g[i]!r} against {w[i]!r}")


def tail_counts(log_lik_rows: np.ndarray, m: int) -> np.ndarray:
    """PSIS tail length per row in the rows' own dtype: the values of
    ``-log_lik`` less the row's largest that lie strictly above the
    (m + 1)-th largest, floored at log(float64 tiny)."""
    x = -np.sort(log_lik_rows, axis=1)
    shifted = x - x[:, :1]
    cut = np.maximum(shifted[:, m], np.asarray(math.log(np.finfo(np.float64).tiny), x.dtype))
    return (shifted[:, :m] > cut[:, None]).sum(axis=1)


def held_f32(got_e, got_k, want_e, want_k, ties, what: str, fails: list) -> None:
    """Float32 loo_i within F32_TOL_LOO_I (1 + |want|) and k within
    F32_TOL_K of ``want``, the ``ties`` rows within F32_TOL_TIE."""
    ge, gk, we, wk = _np(got_e), _np(got_k), _np(want_e), _np(want_k)
    tol_e = np.where(ties, F32_TOL_TIE, F32_TOL_LOO_I) * (1 + np.abs(np.nan_to_num(we)))
    tol_k = np.where(ties, F32_TOL_TIE, F32_TOL_K)
    for name, g, w, tol in (("loo_i", ge, we, tol_e), ("pareto_k", gk, wk, tol_k)):
        same = (g == w) | (np.isnan(g) & np.isnan(w))
        with np.errstate(invalid="ignore"):
            bad = ~(same | (np.abs(g - w) <= tol))
        if bad.any():
            i = int(np.argmax(bad))
            fails.append(f"{what} {name}: {int(bad.sum())} of {g.size} rows beyond the float32"
                         f" envelope ({int(ties.sum())} tie rows); first at {i}: {g[i]!r}"
                         f" against {w[i]!r}")


# --------------------------------------------------------------------------
# the modes: draw(rng, trial) -> spec, run(spec) -> results on the current
# device, check(spec, results) -> failures; CARD_KEYS the float64 results
# held card against CPU
# --------------------------------------------------------------------------


def draw_streaming(rng, trial):
    B = int(rng.integers(5, 120))
    S = int(rng.integers(8, 600))
    dist = DISTS[int(rng.integers(len(DISTS)))]
    ll = gen_ll(rng, dist, B, S)
    reff = float(rng.uniform(0.3, 1.0))
    chunk = int(rng.integers(4, B + 32))
    x = rng.normal(0, 1, size=(B, S))
    gids = rng.integers(0, max(2, B // 6), size=B)
    return dict(B=B, S=S, dist=dist, ll=ll, reff=reff, chunk=chunk, x=x, gids=gids,
                tag=f"dist={dist} B={B} S={S} reff={reff:.2f} chunk={chunk}")


def run_streaming(spec, device):
    from .. import (e_loo, e_loo_streaming, loo, loo_group, loo_group_streaming,
                    loo_streaming, psislw, psislw_compact, waic, waic_streaming)
    from ..containers import DataArray

    B, S, ll, reff, chunk = spec["B"], spec["S"], spec["ll"], spec["reff"], spec["chunk"]
    ll_fn, idata = _rows_fn(ll, device), _idata(ll)
    out = {}
    ref = loo(idata, reff=reff, pointwise=True)
    got = loo_streaming(ll_fn, B, S, reff=reff, chunk_size=chunk, pointwise=True,
                        dtype=torch.float64)
    for name, res in (("loo", ref), ("loo_streaming", got)):
        out[f"{name}.elpd"] = res["elpd_loo"]
        out[f"{name}.loo_i"] = res.loo_i
        out[f"{name}.pareto_k"] = res.pareto_k
    out["psislw"] = psislw(-ll, reff=reff)[0]
    out["densify"] = psislw_compact(-ll, reff=reff).densify(-ll)
    wref = waic(idata, pointwise=True)
    wgot = waic_streaming(ll_fn, B, S, chunk_size=chunk, dtype=torch.float64, pointwise=True)
    for name, res in (("waic", wref), ("waic_streaming", wgot)):
        out[f"{name}.elpd"] = res["elpd_waic"]
        out[f"{name}.waic_i"] = res.waic_i
    x_fn = _rows_fn(spec["x"], device)
    lwm = psislw(-ll)[0]
    for kind in ("mean", "sd"):
        er = e_loo_streaming(ll_fn, x_fn, B, S, type=kind, chunk_size=chunk,
                             dtype=torch.float64)
        eref = e_loo(DataArray(spec["x"], ("obs", "__sample__")),
                     log_weights=DataArray(np.asarray(lwm), ("obs", "__sample__")),
                     log_ratios=DataArray(-ll, ("obs", "__sample__")), type=kind)
        out[f"e_loo_streaming.{kind}"] = er.value
        out[f"e_loo.{kind}"] = eref.value
    gids = spec["gids"]
    out["loo_group_streaming.elpd"] = loo_group_streaming(ll_fn, gids, B, S, chunk_size=chunk,
                                                          dtype=torch.float64)["elpd_logo"]
    out["loo_group.elpd"] = loo_group(idata, gids, reff=1.0)["elpd_logo"]
    return {key: _np(v) for key, v in out.items()}


def check_streaming(spec, r):
    fails: list = []
    held(r["loo_streaming.elpd"], r["loo.elpd"], 1e-9, 0.0, "loo_streaming elpd", fails)
    held(r["loo_streaming.loo_i"], r["loo.loo_i"], 1e-8, 1e-12, "loo_streaming loo_i", fails)
    kr, kg = r["loo.pareto_k"], r["loo_streaming.pareto_k"]
    finite = np.isfinite(kr)
    held(kg[finite], kr[finite], 1e-6, 1e-9, "loo_streaming pareto_k", fails)
    if not np.array_equal(np.isfinite(kg), finite):
        fails.append("loo_streaming pareto_k: the inf rows differ from loo's")
    held(r["densify"], r["psislw"], 1e-10, 1e-12, "psislw_compact densify", fails)
    held(r["waic_streaming.elpd"], r["waic.elpd"], 1e-9, 0.0, "waic_streaming elpd", fails)
    held(r["waic_streaming.waic_i"], r["waic.waic_i"], 1e-8, 0.0, "waic_streaming waic_i", fails)
    for kind in ("mean", "sd"):
        held(r[f"e_loo_streaming.{kind}"], r[f"e_loo.{kind}"], 1e-7, 1e-10,
             f"e_loo_streaming {kind}", fails)
    held(r["loo_group_streaming.elpd"], r["loo_group.elpd"], 1e-9, 0.0,
         "loo_group_streaming elpd_logo", fails)
    return fails


def draw_nonfactor(rng, trial):
    N = int(rng.integers(4, 26))
    C, T = 1, int(rng.integers(5, 30))
    spread = rng.uniform(0.1, 1.0)
    A = rng.normal(size=(N, N)) * spread
    base = A @ A.T + rng.uniform(0.05, 1.0) * np.eye(N)
    mu0 = rng.normal(size=N)
    y = rng.multivariate_normal(mu0, base)
    mus = mu0[None, None, :] + rng.normal(0, 0.05, size=(C, T, N))
    covs = np.empty((C, T, N, N))
    for t in range(T):
        j = rng.normal(0, 0.01, size=(N, N))
        covs[0, t] = base + (j + j.T) / 2 + 0.01 * np.eye(N)
    return dict(N=N, T=T, y=y, mus=mus, covs=covs, tag=f"N={N} T={T}")


def nonfactor_oracle_ll(spec) -> np.ndarray:
    """``(N, T)`` conditional log-likelihoods, each from the partitioned
    normal of one draw and observation, in NumPy."""
    from scipy import stats

    N, T, y, mus, covs = spec["N"], spec["T"], spec["y"], spec["mus"], spec["covs"]
    ll = np.empty((N, T))
    for t in range(T):
        mu_t, cov_t = mus[0, t], covs[0, t]
        for i in range(N):
            keep = np.delete(np.arange(N), i)
            c22i = np.linalg.inv(cov_t[np.ix_(keep, keep)])
            c12 = cov_t[np.ix_([i], keep)]
            m = mu_t[i] + (c12 @ c22i @ (y[keep] - mu_t[keep]))[0]
            v = cov_t[i, i] - (c12 @ c22i @ c12.T)[0, 0]
            ll[i, t] = stats.norm.logpdf(y[i], m, np.sqrt(v))
    return ll


def run_nonfactor(spec, device):
    from .. import from_dict, loo_nonfactor, psislw

    idata = from_dict(posterior={"mu": spec["mus"], "cov": spec["covs"]},
                      observed_data={"y": spec["y"]})
    res = loo_nonfactor(idata, pointwise=True)
    ll = spec.get("oracle_ll")
    if ll is None:
        ll = spec["oracle_ll"] = nonfactor_oracle_ll(spec)
    lw = np.asarray(psislw(-ll, reff=1.0)[0])
    want = np.array([np.logaddexp.reduce(lw[i] + ll[i]) for i in range(spec["N"])])
    return {"loo_nonfactor.loo_i": _np(res.loo_i), "loo_nonfactor.elpd": _np(res["elpd_loo"]),
            "oracle.loo_i": want}


def check_nonfactor(spec, r):
    fails: list = []
    held(r["loo_nonfactor.loo_i"], r["oracle.loo_i"], 1e-6, 1e-9, "loo_nonfactor loo_i", fails)
    return fails


def draw_fast32(rng, trial):
    dists = ("normal", "t", "exp", "ties", "bimodal")
    B = int(rng.integers(5, 160))
    S = int(rng.integers(8, 900))
    dist = dists[int(rng.integers(len(dists)))]
    ll = gen_ll(rng, dist, B, S)
    chunk = int(rng.integers(4, B + 32))
    return dict(B=B, S=S, dist=dist, ll=ll, chunk=chunk,
                tag=f"dist={dist} B={B} S={S} chunk={chunk}")


def run_fast32(spec, device):
    from .. import loo_streaming
    from ..ops.loo_kernels import loo_scores_psis_fast
    from ..ops.psis import tail_length

    B, S, ll, chunk = spec["B"], spec["S"], spec["ll"], spec["chunk"]
    out = {}
    for name, dtype in (("exact", torch.float64), ("fast", torch.float32)):
        res = loo_streaming(_rows_fn(ll, device, dtype), B, S, chunk_size=chunk,
                            pointwise=True, dtype=dtype)
        out[f"{name}.elpd"] = _np(res["elpd_loo"])
        out[f"{name}.loo_i"] = _np(res.loo_i)
        out[f"{name}.pareto_k"] = _np(res.pareto_k)
    if torch.device(device).type == "cuda":
        # kernel A's route (the default on the card) against the plain route
        rows = torch.as_tensor(ll, dtype=torch.float32, device=device)
        m = tail_length(S)
        for route in (None, "torch"):
            elpd_i, k, _, _ = loo_scores_psis_fast(rows, m, route=route)
            name = "route.kernel" if route is None else "route.torch"
            out[f"{name}.loo_i"], out[f"{name}.pareto_k"] = _np(elpd_i), _np(k)
    return out


def fast32_ties(spec) -> np.ndarray:
    """Rows whose float32 tail differs from the float64 one by a cutoff tie."""
    from ..ops.psis import tail_length

    m = tail_length(spec["S"])
    return tail_counts(spec["ll"].astype(np.float32), m) != tail_counts(spec["ll"], m)


def check_fast32(spec, r):
    fails: list = []
    scale = max(abs(float(r["exact.elpd"][0])), 1.0)
    diff = abs(float(r["fast.elpd"][0]) - float(r["exact.elpd"][0]))
    if not diff / scale < 2e-3:
        fails.append(f"fast32 elpd diff {diff:.3g} vs scale {scale:.3g}")
    ke, kf = r["exact.pareto_k"], r["fast.pareto_k"]
    m = np.isfinite(ke) & np.isfinite(kf)
    if m.any() and not np.max(np.abs(ke[m] - kf[m])) < 0.08:
        fails.append(f"fast32 k diff {np.max(np.abs(ke[m] - kf[m])):.3g}")
    if "route.kernel.loo_i" in r:
        held_f32(r["route.kernel.loo_i"], r["route.kernel.pareto_k"], r["route.torch.loo_i"],
                 r["route.torch.pareto_k"], fast32_ties(spec),
                 "kernel A's route against the plain route", fails)
    return fails


def draw_subsample(rng, trial):
    B = int(rng.integers(40, 400))
    S = int(rng.integers(10, 300))
    ll = gen_ll(rng, ("normal", "t", "exp")[int(rng.integers(3))], B, S)
    m = int(rng.integers(5, max(6, B // 2)))
    idx = np.sort(rng.choice(B, size=m, replace=False))
    est = ("diff_srs", "srs", "hh_pps")[int(rng.integers(3))]
    return dict(B=B, S=S, ll=ll, m=m, idx=idx, est=est, tag=f"est={est} B={B} S={S} m={m}")


SUBSAMPLE_KEYS = ("elpd_loo", "se", "subsampling_SE", "p_loo")


def run_subsample(spec, device):
    from .. import loo_subsample, loo_subsample_streaming

    got = loo_subsample_streaming(_rows_fn(spec["ll"], device), spec["B"], spec["S"],
                                  observations=spec["idx"], estimator=spec["est"],
                                  dtype=torch.float64)
    ref = loo_subsample(_idata(spec["ll"]), observations=spec["idx"], estimator=spec["est"],
                        loo_approximation="lpd", reff=1.0)
    out = {f"streaming.{key}": _np(got[key]) for key in SUBSAMPLE_KEYS}
    out.update({f"loo_subsample.{key}": _np(ref[key]) for key in SUBSAMPLE_KEYS})
    return out


def check_subsample(spec, r):
    fails: list = []
    for key in SUBSAMPLE_KEYS:
        held(r[f"streaming.{key}"], r[f"loo_subsample.{key}"], 1e-8, 1e-10,
             f"loo_subsample_streaming {key}", fails)
    return fails


def draw_mesh(rng, trial):
    B = int(rng.integers(9, 300))
    S = int(rng.integers(8, 500))
    ll = gen_ll(rng, ("normal", "t", "ties")[int(rng.integers(3))], B, S)
    chunk = int(rng.integers(8, B + 64))
    return dict(B=B, S=S, ll=ll, chunk=chunk, tag=f"B={B} S={S} chunk={chunk}")


def fuzz_mesh_of(device):
    """``obs_mesh()`` with two cards or more, else four shards of the one
    device."""
    from ..parallel import Mesh, obs_mesh

    mesh = obs_mesh() if torch.device(device).type == "cuda" else None
    return mesh if mesh is not None else Mesh([str(device)] * 4)


def run_mesh(spec, device):
    from .. import loo_streaming

    out = {}
    for name, mesh in (("sharded", fuzz_mesh_of(device)), ("plain", None)):
        res = loo_streaming(_rows_fn(spec["ll"], device), spec["B"], spec["S"],
                            chunk_size=spec["chunk"], pointwise=True, mesh=mesh,
                            dtype=torch.float64)
        out[f"{name}.elpd"], out[f"{name}.loo_i"] = _np(res["elpd_loo"]), _np(res.loo_i)
    return out


def check_mesh(spec, r):
    fails: list = []
    held(r["sharded.elpd"], r["plain.elpd"], 1e-12, 0.0, "mesh elpd", fails)
    held(r["sharded.loo_i"], r["plain.loo_i"], 1e-11, 0.0, "mesh loo_i", fails)
    return fails


def draw_lfo(rng, trial):
    n = int(rng.integers(15, 90))
    s = int(rng.integers(50, 1500))
    m_ahead = int(rng.integers(1, 4))
    L = int(rng.integers(3, max(4, n - m_ahead - 3)))
    reff = float(rng.uniform(0.5, 1.5))
    ll = gen_ll(rng, ("normal", "t", "exp", "ties", "bimodal")[trial % 5], n, s)
    return dict(n=n, s=s, M=m_ahead, L=L, reff=reff, ll=ll,
                tag=f"n={n} s={s} L={L} M={m_ahead} reff={reff:.2f}")


def run_lfo(spec, device):
    from .. import from_dict, loo_lfo, psislw

    n, s, M, L, reff, ll = (spec[k] for k in ("n", "s", "M", "L", "reff", "ll"))
    res = loo_lfo(from_dict(log_likelihood={"obs": ll.T.reshape(1, s, n)}), L, M=M, reff=reff,
                  pointwise=True)
    n_targets = n - M - L + 1
    want, want_k = np.empty(n_targets), np.empty(n_targets)
    for t in range(n_targets):  # each target on its own: NumPy sums, one-row psislw
        i = L + t
        joint = ll[i : i + M].sum(axis=0)
        if t == 0:
            c = joint.max()
            want[t], want_k[t] = c + np.log(np.mean(np.exp(joint - c))), 0.0
        else:
            lw, k = psislw(ll[L:i].sum(axis=0), reff=reff)
            x = np.asarray(lw) + joint
            c = x.max()
            want[t], want_k[t] = c + np.log(np.sum(np.exp(x - c))), float(k)
    return {"lfo.lfo_i": _np(res["lfo_i"]), "lfo.pareto_k": _np(res["pareto_k"]),
            "lfo.n": np.array([res["n_data_points"]], float), "oracle.lfo_i": want,
            "oracle.pareto_k": want_k}


def check_lfo(spec, r):
    fails: list = []
    n_targets = spec["n"] - spec["M"] - spec["L"] + 1
    if int(r["lfo.n"][0]) != n_targets:
        fails.append(f"lfo n_data_points {int(r['lfo.n'][0])} against {n_targets}")
        return fails
    held(r["lfo.lfo_i"], r["oracle.lfo_i"], 1e-9, 1e-9, "loo_lfo lfo_i", fails)
    held(r["lfo.pareto_k"], r["oracle.pareto_k"], 1e-9, 1e-12, "loo_lfo pareto_k", fails)
    return fails


def draw_mm(rng, trial):
    p = int(rng.integers(1, 5))
    n = int(rng.integers(12, 40))
    s = int(rng.integers(300, 900))
    X = rng.normal(size=(n, p))
    beta_true = rng.normal(size=p)
    y = X @ beta_true + rng.normal(size=n)
    n_out = int(rng.integers(1, 4))
    y[rng.choice(n, n_out, replace=False)] += rng.uniform(4, 9, n_out)
    # the exact conjugate posterior: beta | y ~ N(mu_n, Sigma_n)
    cov = np.linalg.inv(np.eye(p) + X.T @ X)
    mu_n = cov @ (X.T @ y)
    draws = mu_n + rng.normal(size=(s, p)) @ np.linalg.cholesky(cov).T
    quantile = rng.uniform(0.5, 0.9)
    split = bool(rng.integers(0, 2))
    cov_t = bool(rng.integers(0, 2))
    return dict(p=p, n=n, s=s, X=X, y=y, draws=draws, quantile=quantile, split=split,
                cov=cov_t, trial=trial,
                tag=f"p={p} n={n} s={s} split={split} cov={cov_t}")


def regression_model(spec):
    """The conjugate regression ``y ~ N(X beta, 1)``, ``beta ~ N(0, I)``, as
    torch functions."""
    from ..models.wrapper import Model

    half_log_2pi = 0.5 * math.log(2 * math.pi)

    def logp(params, data):
        b = params["beta"]
        r = data["y"] - data["X"] @ b
        return -0.5 * torch.sum(b**2) - 0.5 * torch.sum(r**2)

    def log_lik(params, data):
        r = data["y"] - data["X"] @ params["beta"]
        return -half_log_2pi - 0.5 * r**2

    return Model(f"reg{spec['trial']}", {"y": spec["y"], "X": spec["X"]},
                 {"beta": (spec["p"],)}, logp, log_lik, obs_keys=("y", "X"))


def run_mm(spec, device):
    from .. import JAXModelWrapper, loo, loo_moment_match
    from ..models.wrapper import idata_from_flat_draws

    model = regression_model(spec)
    idata = idata_from_flat_draws(model, spec["draws"].reshape(1, spec["s"], spec["p"]))
    wrapper = JAXModelWrapper(model, idata)
    orig = loo(idata, pointwise=True, reff=1.0)
    thresh = float(np.quantile(_np(orig.pareto_k), spec["quantile"]))
    out = {"threshold": np.array([thresh])}
    for name, batched in (("host", False), ("device", True)):
        res = loo_moment_match(wrapper, orig, k_threshold=thresh, split=spec["split"],
                               cov=spec["cov"], device_batched=batched)
        out[f"{name}.loo_i"] = _np(res.loo_i)
        out[f"{name}.pareto_k"] = _np(res.pareto_k)
        out[f"{name}.elpd"] = _np(res["elpd_loo"])
    return out


def check_mm(spec, r):
    fails: list = []
    held(r["device.loo_i"], r["host.loo_i"], 1e-8, 1e-8, "moment matching loo_i", fails)
    held(r["device.pareto_k"], r["host.pareto_k"], 1e-8, 1e-8, "moment matching pareto_k",
         fails)
    held(r["device.elpd"], r["host.elpd"], 1e-8, 0.0, "moment matching elpd", fails)
    return fails


def trials_of(mode: str, trials: int) -> int:
    """The script's share of ``trials`` for each mode."""
    return {"nonfactor": max(trials // 3, 4), "mesh": max(trials // 3, 4),
            "lfo": max(trials // 2, 5), "mm": max(trials // 5, 4)}.get(mode, trials)


def card_against_cpu(mode: str, spec, card: dict, cpu: dict, fails: list) -> None:
    """Every float64 result of the trial on the card against the CPU's
    within CARD_CPU_TOL; fast32's float32 results within the envelope."""
    for key, want in cpu.items():
        if key.startswith(("fast.", "route.")) or key not in card:
            continue
        tol = MM_K_TOL if mode == "mm" and key.endswith(".pareto_k") else CARD_CPU_TOL
        held(card[key], want, tol, tol, f"card against CPU: {key}", fails)
    if mode == "fast32":
        held_f32(card["fast.loo_i"], card["fast.pareto_k"], cpu["fast.loo_i"],
                 cpu["fast.pareto_k"], fast32_ties(spec), "card against CPU: float32", fails)


def fuzz_mode(mode: str, trials: int, seed: int, device: torch.device) -> dict:
    """``trials`` trials of one mode on ``device`` (and, on the card, each
    again on the CPU); returns ``{"trials", "failures", "seconds"}``."""
    draw, run, check = (globals()[f"{step}_{mode}"] for step in ("draw", "run", "check"))
    rng = np.random.default_rng(seed)
    failures = 0
    t0 = time.perf_counter()
    for trial in range(trials):
        spec = draw(rng, trial)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with on_device(device):
                got = run(spec, device)
            fails = check(spec, got)
            if device.type == "cuda":
                with on_device("cpu"):
                    cpu = run(spec, torch.device("cpu"))
                card_against_cpu(mode, spec, got, cpu, fails)
        if fails:
            failures += 1
            print(f"{mode.upper()} FAIL trial {trial} {spec['tag']}", flush=True)
            for msg in fails:
                print(f"  {msg[:400]}", flush=True)
    seconds = time.perf_counter() - t0
    print(f"{mode} fuzz done: {trials} trials, {failures} failures, {seconds:.1f} s on"
          f" {platform_of(device)}" + (" (each also on the CPU)" if device.type == "cuda" else ""),
          flush=True)
    return {"trials": trials, "failures": failures, "seconds": seconds}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m pyloo_tpu_torch.tools.fuzz_differential",
        description="Randomised differential fuzz of the port's entry points, on the card.")
    parser.add_argument("trials", nargs="?", type=int, default=40)
    parser.add_argument("seed", nargs="?", type=int, default=20260818)
    parser.add_argument("mode", nargs="?", default="streaming", choices=(*MODES, "all"))
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "fuzz_differential")
    print(f"fuzz_differential on {platform_of(device)} ({card_of(device) or 'no card'}),"
          f" seed {args.seed}", flush=True)
    modes = MODES if args.mode == "all" else (args.mode,)
    rc = 0
    for mode in modes:
        res = fuzz_mode(mode, trials_of(mode, args.trials), args.seed, device)
        rc |= int(res["failures"] > 0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
