"""The per-observation scorers against pyloo_tpu's on the same numpy inputs.

Float64 scorers within rtol and atol 1e-12.  The float32 scorer within rtol
and atol 1e-5 on elpd_i and lppd_i and atol 1e-3 on k, with identical
``degenerate`` flags: both packages select the same tail exactly, then run
the float32 signed-log fit with transcendentals an ulp apart, which moves k
by ~1e-5 at most and elpd by less.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pyloo_tpu.ops import loo_kernels as jk
from pyloo_tpu_torch import rcParams
from pyloo_tpu_torch.ops import loo_kernels as tk
from pyloo_tpu_torch.ops import topk
from pyloo_tpu_torch.ops.psis import tail_length

F64 = dict(rtol=1e-12, atol=1e-12)
S = 2000
M = tail_length(S)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = rcParams["device.device"]
    rcParams["device.device"] = "cpu"
    yield
    rcParams["device.device"] = old


def _log_lik(deep: bool, b=24, seed=0):
    """Normal and Student-t rows; ``deep`` adds a row whose tail lies > 60
    nats below the row max (the float64 deep-tail guard's other branch)."""
    rng = np.random.default_rng(seed)
    ll = rng.normal(-1, 0.7, size=(b, S))
    ll[: b // 3] = 2.0 * rng.standard_t(3, size=(b // 3, S)) - 1.0
    ll[b // 3] = -2.5  # constant row: no tail, never smoothed
    if deep:
        ll[5] = rng.standard_t(2, size=S) * 8.0 - 30.0
    return ll


def _spy(monkeypatch, name):
    calls = []
    real = getattr(tk, name)

    def spy(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(tk, name, spy)
    return calls


@pytest.mark.parametrize("deep", [False, True], ids=["linear-fit", "deep-tail-guard"])
def test_loo_scores_psis_float64(monkeypatch, deep):
    ll = _log_lik(deep)
    linear = _spy(monkeypatch, "_gpdfit_from_y")
    signed_log = _spy(monkeypatch, "_gpdfit_batch")
    got = tk.loo_scores_psis(torch.from_numpy(ll), M)
    want = jk.loo_scores_psis(jnp.asarray(ll), M)
    # the batch-level guard took the branch the data calls for
    assert (len(linear), len(signed_log)) == ((0, 1) if deep else (1, 0))
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **F64)


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_loo_scores_psis_fast_float32(route):
    # "cuda" on a CPU tensor runs the fused branch over the prepass's plain
    # version; "torch" is the plain scorer (pyloo_tpu's CPU cascade branch)
    ll = _log_lik(deep=True, seed=1).astype(np.float32)
    ll[7, ::9] = -np.inf  # x = +inf entries, as a log-lik of -inf gives
    got = tk.loo_scores_psis_fast(torch.from_numpy(ll), M, route=route)
    want = jk.loo_scores_psis_fast(jnp.asarray(ll), M)
    e, k, lppd, degen = (g.numpy() for g in got)
    we, wk, wlppd, wdegen = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(degen, wdegen)
    assert_allclose(e, we, rtol=1e-5, atol=1e-5)
    assert_allclose(lppd, wlppd, rtol=1e-5, atol=1e-5)
    assert_allclose(k, wk, rtol=0, atol=1e-3)


def test_loo_scores_psis_fast_default_route_on_cpu():
    ll = torch.from_numpy(_log_lik(deep=False, b=6).astype(np.float32))
    before = topk.loo_prepass.launches
    got = tk.loo_scores_psis_fast(ll, M)
    want = tk.loo_scores_psis_fast(ll, M, route="torch")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert topk.loo_prepass.launches == before


def test_plain_route_reaches_no_kernel_wrapper(monkeypatch):
    # route="torch" is the reference a run on the card is checked against:
    # it must not reach kernel A or B (whose wrappers, on the card, launch)
    from pyloo_tpu_torch.ops import selection

    def refuse(*args, **kwargs):
        raise AssertionError("the plain scorer reached a kernel wrapper")

    for module in (tk, topk, selection):
        for name in ("loo_prepass", "loo_prepass_multi", "topk_desc"):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, refuse)
    ll = _log_lik(deep=False, b=8, seed=4).astype(np.float32)
    got = tk.loo_scores_psis_fast(torch.from_numpy(ll), M, route="torch")
    want = jk.loo_scores_psis_fast(jnp.asarray(ll), M)
    assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("fn", ["loo_scores_sis", "loo_scores_tis", "mixture_scores"])
def test_sis_tis_mixture(fn):
    ll = _log_lik(deep=False, b=12, seed=2)
    got = getattr(tk, fn)(torch.from_numpy(ll))
    want = getattr(jk, fn)(jnp.asarray(ll))
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **F64)


def test_float32_cutoff_tie_moves_k_as_in_pyloo_tpu():
    # Two draws that straddle the float64 tail cutoff by 1e-10 round to one
    # float32 value, so the strict-> tail loses an element in float32 and k
    # moves by ~1e-2, beyond the float32 envelope's 2e-3 (rare: one row in
    # 250,000 logistic-regression rows, on an H100 and on the CPU alike).
    # The port's float32 path moves exactly as pyloo_tpu's does.
    rng = np.random.default_rng(9)
    ll = rng.normal(-1, 0.7, size=(4, S))
    for row in ll:
        order = np.argsort(row)  # ascending log-lik: descending x = -ll
        v = float(np.float32(row[order[M]]))
        row[order[M - 1]], row[order[M]] = v - 1e-10, v + 1e-10
    e64, k64, _ = (a.numpy() for a in tk.loo_scores_psis(torch.from_numpy(ll), M))
    e32, k32, _, _ = (
        a.numpy() for a in tk.loo_scores_psis_fast(torch.from_numpy(ll.astype(np.float32)), M)
    )
    jk32 = np.asarray(jk.loo_scores_psis_fast(jnp.asarray(ll.astype(np.float32)), M)[1])
    assert_allclose(k32, jk32, rtol=0, atol=1e-5)
    assert (np.abs(k32 - k64) > 2e-3).all()
    assert_allclose(e32, e64, rtol=1e-4, atol=1e-4)  # elpd stays in the envelope


# Rows whose fitted sigma is not positive.  No input was found on which
# pyloo_tpu's fit returns one with a finite k (its own tests stub the flag
# for the same reason: k and b come out with opposite signs by construction,
# and a b that cancels falls back to the exponential limit; tied and nearly
# tied tails, a few distinct tail values, outliers up to 100 nats, spreads up
# to 1000 nats and Student-t rows with 0.5 and 1 degrees of freedom, 512 rows
# each, raised none).  So both packages' fits are made to report sigma <= 0
# on the same rows, and everything after the fit is held to pyloo_tpu: the
# flags, the NaN rows of the float64 scorer, the unsmoothed tail that the
# float32 scorer keeps.  S = 1777 is used nowhere else, so pyloo_tpu traces
# its jitted scorers here with the stubbed fit, and the traces are dropped.
_DEGENERATE_ROWS = (1, 4, 9)


def _flip_sigma(monkeypatch, module, signs):
    """Make both fits of ``module`` report a non-positive sigma on
    ``_DEGENERATE_ROWS``; ``signs(b)`` is -1 there and +1 elsewhere."""
    batch, from_y = module._gpdfit_batch, module._gpdfit_from_y

    def hit(like):
        return signs(like.shape[0])

    def stub_batch(*args, **kwargs):
        k, sign_sigma, log_sigma = batch(*args, **kwargs)
        return k, sign_sigma * hit(k), log_sigma

    def stub_from_y(*args, **kwargs):
        k, sigma = from_y(*args, **kwargs)
        return k, sigma * hit(k)

    monkeypatch.setattr(module, "_gpdfit_batch", stub_batch)
    monkeypatch.setattr(module, "_gpdfit_from_y", stub_from_y)


def _stub_both_fits(monkeypatch):
    def np_signs(b):
        signs = np.ones(b)
        signs[list(_DEGENERATE_ROWS)] = -1.0
        return signs

    _flip_sigma(monkeypatch, jk, lambda b: jnp.asarray(np_signs(b)))
    _flip_sigma(monkeypatch, tk, lambda b: torch.from_numpy(np_signs(b)))


def _degenerate_log_lik():
    rng = np.random.default_rng(11)
    ll = rng.normal(-1, 0.7, size=(12, 1777))
    ll[:4] = 2.0 * rng.standard_t(3, size=(4, 1777)) - 1.0
    return ll


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_degenerate_rows_float32_keep_the_unsmoothed_tail(monkeypatch, route):
    import jax

    ll = _degenerate_log_lik().astype(np.float32)
    m = tail_length(ll.shape[1])
    clean = tk.loo_scores_psis_fast(torch.from_numpy(ll), m, route=route)
    _stub_both_fits(monkeypatch)
    try:
        want = jk.loo_scores_psis_fast(jnp.asarray(ll), m)
        got = tk.loo_scores_psis_fast(torch.from_numpy(ll), m, route=route)
    finally:
        jax.clear_caches()
    e, k, lppd, degen = (g.numpy() for g in got)
    we, wk, wlppd, wdegen = (np.asarray(w) for w in want)
    rows = list(_DEGENERATE_ROWS)
    assert wdegen[rows].all() and wdegen.sum() == len(rows)  # pyloo_tpu raises the flag
    np.testing.assert_array_equal(degen, wdegen)
    assert_allclose(e, we, rtol=1e-5, atol=1e-5)
    assert_allclose(lppd, wlppd, rtol=1e-5, atol=1e-5)
    assert_allclose(k, wk, rtol=0, atol=1e-3)
    # the flagged rows are finite and unsmoothed: they differ from the clean fit's
    assert np.isfinite(e[rows]).all()
    assert (np.abs(e[rows] - clean[0].numpy()[rows]) > 1e-4).all()
    others = np.setdiff1d(np.arange(len(e)), rows)
    np.testing.assert_array_equal(e[others], clean[0].numpy()[others])


@pytest.mark.parametrize("deep", [False, True], ids=["linear-fit", "deep-tail-guard"])
def test_degenerate_rows_float64_are_nan_as_in_pyloo_tpu(monkeypatch, deep):
    import jax

    ll = _degenerate_log_lik()
    if deep:  # the batch takes the signed-log fit
        ll[5] = np.random.default_rng(12).standard_t(2, size=ll.shape[1]) * 8.0 - 30.0
    m = tail_length(ll.shape[1])
    _stub_both_fits(monkeypatch)
    try:
        want = [np.asarray(w) for w in jk.loo_scores_psis(jnp.asarray(ll), m)]
        want_fast = [np.asarray(w) for w in jk.loo_scores_psis_fast(jnp.asarray(ll), m)]
    finally:
        jax.clear_caches()
    got = [g.numpy() for g in tk.loo_scores_psis(torch.from_numpy(ll), m)]
    got_fast = [g.numpy() for g in tk.loo_scores_psis_fast(torch.from_numpy(ll), m)]
    rows = list(_DEGENERATE_ROWS)
    assert np.isnan(want[0][rows]).all() and np.isnan(want[0]).sum() == len(rows)
    for g, w in zip(got, want):
        assert_allclose(g, w, **F64)  # NaN rows included (equal_nan is the default)
    np.testing.assert_array_equal(got_fast[3], want_fast[3])
    assert want_fast[3][rows].all()
    for g, w in zip(got_fast[:3], want_fast[:3]):
        assert_allclose(g, w, **F64)
