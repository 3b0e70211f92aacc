"""The port's importance weights against ``pyloo_tpu`` on the same numpy inputs.

``topk_with_idx`` against ``jax.lax.top_k`` (values and indices, tie order
included), the rest of ``ops/psis.py`` (``psislw_batch``,
``psislw_compact_batch`` and its readers, ``gpdfit``, ``gpinv``, the linear
fit's two branches) and the public ``psislw`` / ``sislw`` / ``tislw`` /
``psislw_compact``.  Float64 within rtol and atol 1e-12.  Float32 weights
within rtol and atol 2e-5 and k within 1e-3: the two packages round float32
transcendentals an ulp apart and sum the M-term profile likelihood in
another order (measured here: log weights within 2.3e-5 absolute at
S = 200 and 7.6e-6 at S = 1,000, k within 5.2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from .torch_parity import F64, set_precision

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu.ops import psis as jpsis
from pyloo_tpu_torch.ops import psis as tpsis
from pyloo_tpu_torch.ops import selection as tsel
from pyloo_tpu_torch.parallel import apply_rowwise

F32_W = dict(rtol=2e-5, atol=2e-5)
F32_K = dict(rtol=0, atol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


@pytest.fixture
def precision():
    saved = (jpl.rcParams["device.precision"], tpl.rcParams["device.precision"])
    yield set_precision
    jpl.rcParams["device.precision"], tpl.rcParams["device.precision"] = saved


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rows(b=16, s=1000, seed=0, dtype="float64"):
    """Log weights: normal rows, a heavy tail, rows with ties (rounded to 1
    and 0 decimals: the second has a tie run across the cutoff slot), a row
    with <= 4 tail draws and a constant row (k = inf for both)."""
    rng = np.random.default_rng(seed)
    lw = rng.normal(size=(b, s)) * 2
    lw[2] = 3.0 * rng.standard_t(2, size=s)
    lw[3] = np.round(lw[3], 1)
    lw[4] = np.round(lw[4], 0)
    lw[5] = -1.0
    lw[5, :3] = [0.5, 0.7, 0.9]  # 3 draws above the rest
    lw[6] = 0.25
    return lw.astype(dtype)


# --------------------------------------------------------------------------
# topk_with_idx
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k", [41, 150])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_topk_with_idx_tie_order(k, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(12, 400))
    x[0] = np.round(x[0], 1)  # many ties
    x[1] = rng.integers(0, 5, size=400)  # long runs
    x[2] = 1.0  # one run
    x = x.astype(dtype)
    vals, idx = tsel.topk_with_idx(torch.from_numpy(x), k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    vals, idx, jv, ji = _np(vals), _np(idx), _np(jv), _np(ji)
    assert np.array_equal(vals, jv)
    # the values come from where the indices say, and within a run of equal
    # values the indices ascend
    assert np.array_equal(np.take_along_axis(x, idx, axis=1), vals)
    same = vals[:, 1:] == vals[:, :-1]
    assert (np.diff(idx, axis=1)[same] > 0).all()
    # strictly above the k-th value the indices are lax.top_k's; a run that
    # straddles slot k may keep other members of the run
    strict = vals > vals[:, -1:]
    assert np.array_equal(idx[strict], ji[strict])
    for row in idx:
        assert len(set(row.tolist())) == k


def test_topk_with_idx_run_across_slot_k():
    # values 5 > 3 (x6) > 1: k = 4 takes the 5 and three of the six 3s
    x = np.array([[1.0, 3.0, 3.0, 5.0, 3.0, 1.0, 3.0, 3.0, 3.0, 1.0]])
    vals, idx = tsel.topk_with_idx(torch.from_numpy(x), 4)
    assert _np(vals).tolist() == [[5.0, 3.0, 3.0, 3.0]]
    idx = _np(idx)[0]
    assert idx[0] == 3 and set(idx[1:]) <= {1, 2, 4, 6, 7, 8}
    assert (np.diff(idx[1:]) > 0).all()


# --------------------------------------------------------------------------
# psislw_batch and the compact form
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("s", [200, 1000])
def test_psislw_batch(dtype, s):
    lw = _rows(s=s, dtype=dtype)
    before = lw.copy()
    m = tpsis.tail_length(s)
    got_lw, got_k = tpsis.psislw_batch(torch.from_numpy(lw), m)
    want_lw, want_k = jpsis.psislw_batch(jnp.asarray(lw), m)
    assert np.array_equal(lw, before)  # the input is left as it was
    tol_w, tol_k = (F64, F64) if dtype == "float64" else (F32_W, F32_K)
    assert_allclose(_np(got_lw), _np(want_lw), **tol_w)
    assert_allclose(_np(got_k), _np(want_k), **tol_k)
    assert np.isinf(_np(got_k)[[5, 6]]).all()
    assert_allclose(np.exp(_np(got_lw)).sum(axis=1), 1.0, rtol=1e-5)


def test_psislw_batch_s4000():
    lw = _rows(b=8, s=4000, seed=2)
    m = tpsis.tail_length(4000, 0.8)
    got = tpsis.psislw_batch(torch.from_numpy(lw), m)
    want = jpsis.psislw_batch(jnp.asarray(lw), m)
    for g, w in zip(got, want):
        assert_allclose(_np(g), _np(w), **F64)


def test_psislw_batch_tie_rows_use_the_tie_order(monkeypatch):
    """On a row with ties inside the tail the smoothed values depend on the
    order of the tied indices: with that order reversed they differ."""
    lw = _rows()[3:4]
    m = tpsis.tail_length(1000)
    want = _np(jpsis.psislw_batch(jnp.asarray(lw), m)[0])
    got = _np(tpsis.psislw_batch(torch.from_numpy(lw), m)[0])
    assert_allclose(got, want, **F64)

    def reversed_ties(x, k):  # the same values, tied indices descending
        vals, idx = torch.sort(x.flip(1), dim=1, descending=True, stable=True)
        return vals[:, :k], x.shape[1] - 1 - idx[:, :k]

    monkeypatch.setattr(tpsis, "topk_with_idx", reversed_ties)
    wrong = _np(tpsis.psislw_batch(torch.from_numpy(lw), m)[0])
    assert np.abs(wrong - want).max() > 1e-6


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_psislw_compact_batch(dtype):
    lw = _rows(dtype=dtype)
    m = tpsis.tail_length(lw.shape[1])
    got = tpsis.psislw_compact_batch(torch.from_numpy(lw), m)
    want = jpsis.psislw_compact_batch(jnp.asarray(lw), m)
    tol_w, tol_k = (F64, F64) if dtype == "float64" else (F32_W, F32_K)
    log_norm, tail_idx, tail_lw, xcutoff, khat = map(_np, got)
    j_norm, j_idx, j_lw, j_cut, j_k = map(_np, want)
    assert_allclose(log_norm, j_norm, **tol_w)
    assert_allclose(tail_lw, j_lw, **tol_w)
    assert np.array_equal(xcutoff, j_cut)
    assert_allclose(khat, j_k, **tol_k)
    # the indices agree wherever the value is strictly above the cutoff; the
    # other slots hold members of the cutoff's tie run
    x = lw - lw.max(axis=1, keepdims=True)
    strict = np.take_along_axis(x, tail_idx, axis=1) > xcutoff[:, None]
    assert np.array_equal(tail_idx[strict], j_idx[strict])
    # and the patched matrix is psislw_batch's
    dense = lw - log_norm[:, None]
    np.put_along_axis(dense, tail_idx, tail_lw, axis=1)
    assert_allclose(dense, _np(tpsis.psislw_batch(torch.from_numpy(lw), m)[0]), **tol_w)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_compact_weighted_mean_and_moments(dtype):
    lw = _rows(dtype=dtype)
    rng = np.random.default_rng(3)
    h = rng.normal(size=lw.shape).astype(dtype)
    h[1] = 2.0  # constant h: variance exactly 0
    m = tpsis.tail_length(lw.shape[1])
    compact = tpsis.psislw_compact_batch(torch.from_numpy(lw), m)[:4]
    j_compact = jpsis.psislw_compact_batch(jnp.asarray(lw), m)[:4]
    tol = F64 if dtype == "float64" else dict(rtol=1e-4, atol=1e-5)
    got = tpsis.compact_weighted_mean(torch.from_numpy(h), torch.from_numpy(lw), *compact)
    want = jpsis.compact_weighted_mean(jnp.asarray(h), jnp.asarray(lw), *j_compact)
    assert_allclose(_np(got), _np(want), **tol)
    got = tpsis.compact_weighted_moments(torch.from_numpy(h), torch.from_numpy(lw), *compact)
    want = jpsis.compact_weighted_moments(jnp.asarray(h), jnp.asarray(lw), *j_compact)
    assert_allclose(_np(got[0]), _np(want[0]), **tol)
    # the variance divides a difference of sums by 1 - sum(w^2): on the
    # heavy-tail row that amplifies the sums' last-bit differences (measured
    # 9e-12 in float64, 6.1e-4 relative in float32)
    var_tol = dict(rtol=1e-10, atol=1e-10) if dtype == "float64" else dict(rtol=2e-3, atol=1e-5)
    assert_allclose(_np(got[1]), _np(want[1]), **var_tol)
    assert _np(got[1])[1] == 0.0


def test_compact_reader_keeps_poisoned_rows_nan():
    lw = torch.from_numpy(_rows(b=8))
    m = tpsis.tail_length(lw.shape[1])
    log_norm, tail_idx, tail_lw, xcutoff, _ = tpsis.psislw_compact_batch(lw, m)
    log_norm = log_norm.clone()
    log_norm[0] = float("nan")
    h = torch.ones_like(lw)
    mean = tpsis.compact_weighted_mean(h, lw, log_norm, tail_idx, tail_lw, xcutoff)
    moments = tpsis.compact_weighted_moments(h, lw, log_norm, tail_idx, tail_lw, xcutoff)
    assert torch.isnan(mean[0]) and torch.isnan(moments[0][0]) and torch.isnan(moments[1][0])
    assert torch.isfinite(mean[1:]).all()


def _deep_tail_rows(s=600, seed=4):
    """Rows whose tail quartile sits more than 60 nats below the row max:
    the float64 batch takes the signed-log fit."""
    rng = np.random.default_rng(seed)
    lw = rng.normal(size=(6, s))
    lw[1] = -200.0 + rng.normal(size=s)
    lw[1, 0] = 0.0  # one draw carries the row: its max, 200 nats above the tail
    return lw


def test_psislw_batch_deep_tail_takes_the_signed_log_fit(monkeypatch):
    lw = _deep_tail_rows()
    m = tpsis.tail_length(lw.shape[1])
    taken = []
    real = tpsis._gpdfit_batch
    monkeypatch.setattr(tpsis, "_gpdfit_batch", lambda *a, **k: taken.append(1) or real(*a, **k))
    got = tpsis.psislw_batch(torch.from_numpy(lw), m)
    assert taken  # the batch-level rule sent float64 rows to the signed-log fit
    want = jpsis.psislw_batch(jnp.asarray(lw), m)
    for g, w in zip(got, want):
        assert_allclose(_np(g), _np(w), **F64)
    taken.clear()
    tpsis.psislw_batch(torch.from_numpy(lw[[0, 2, 3]]), m)
    assert not taken  # ordinary rows take the linear fit


def test_psislw_chunked_equals_whole():
    lw = np.concatenate([_rows(), _deep_tail_rows(s=1000)])
    x = torch.from_numpy(lw)
    m = tpsis.tail_length(1000)
    whole = tpsis.psislw_batch(x, m)
    # 8 rows a chunk: the deep-tail row's decision group is pyloo_tpu's
    # batch, all the rows, so every chunk takes the signed-log fit
    chunked = apply_rowwise(
        lambda b: tpsis.psislw_batch(b, m), x, chunk_bytes=8 * 6 * 1000 * 8, extra_buffers=2
    )
    assert chunked[0].shape == whole[0].shape
    for c, w in zip(chunked, whole):
        assert_allclose(_np(c), _np(w), **F64)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gpdfit_batch_linear_both_branches(dtype):
    rng = np.random.default_rng(5)
    k = rng.uniform(-0.2, 0.9, size=(10, 1))
    y = ((rng.uniform(size=(10, 80)) ** -k - 1) / k)
    y = -np.sort(-y / y.max(axis=1, keepdims=True), axis=1)
    n = rng.integers(5, 81, size=10)
    n[0] = 80
    log_y = np.where(np.arange(80)[None, :] < n[:, None], np.log(y), -np.inf).astype(dtype)
    q_desc = np.clip(n - 1 - np.clip((n + 2) // 4 - 1, 0, 79), 0, 79)
    log_quart = log_y[np.arange(10), q_desc]
    tol = F64 if dtype == "float64" else dict(rtol=2e-4, atol=2e-4)
    for shift in (0.0, -70.0):  # -70: the quartile anchors leave the linear range
        args = (log_y + shift, n, log_quart + shift, log_y[:, 0] + shift)
        got = tpsis._gpdfit_dispatch(*(torch.from_numpy(np.asarray(a)) for a in args))
        want = jax.jit(jpsis._gpdfit_dispatch, static_argnames="product")(
            *(jnp.asarray(a) for a in args), product=True
        )
        assert_allclose(_np(got[0]), _np(want[0]), **tol)
        assert_allclose(_np(got[2]), _np(want[2]), **tol)
        assert np.array_equal(_np(got[1]) > 0, _np(want[1]) > 0)


@pytest.mark.parametrize("batched", [False, True])
def test_gpdfit(batched):
    rng = np.random.default_rng(6)
    ary = np.sort(rng.pareto(3.0, size=(4, 120)), axis=1)
    if not batched:
        ary = ary[0]
    got = tpsis.gpdfit(torch.from_numpy(ary))
    want = jpsis.gpdfit(jnp.asarray(ary))
    for g, w in zip(got, want):
        assert _np(g).shape == _np(w).shape
        assert_allclose(_np(g), _np(w), **F64)


@pytest.mark.parametrize("kappa,sigma", [(0.3, 1.5), (-0.4, 2.0), (0.0, 1.0), (0.5, -1.0)])
def test_gpinv_with_edges(kappa, sigma):
    probs = np.array([0.0, 0.1, 0.5, 0.99, 1.0, 1.5, -0.1])
    got = tpsis.gpinv(torch.from_numpy(probs), kappa, sigma)
    want = jpsis.gpinv(jnp.asarray(probs), kappa, sigma)
    assert_allclose(_np(got), _np(want), equal_nan=True, **F64)
    got2 = tpsis.gpinv(torch.from_numpy(np.stack([probs, probs[::-1]])), kappa, sigma)
    want2 = jpsis.gpinv(jnp.asarray(np.stack([probs, probs[::-1]])), kappa, sigma)
    assert_allclose(_np(got2), _np(want2), equal_nan=True, **F64)


# --------------------------------------------------------------------------
# the public functions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["psislw", "sislw", "tislw"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_public_weights_on_an_ndarray(fn, dtype, precision):
    precision(dtype)
    lw = _rows(b=10, s=400, dtype=dtype)
    before = lw.copy()
    got_lw, got_d = getattr(tpl, fn)(lw)
    want_lw, want_d = getattr(jpl, fn)(lw)
    assert np.array_equal(lw, before)
    assert isinstance(got_lw, np.ndarray) and isinstance(got_d, np.ndarray)
    assert got_lw.shape == want_lw.shape and got_d.shape == want_d.shape
    assert got_lw.dtype == np.dtype(dtype)
    tol_w, tol_k = (F64, F64) if dtype == "float64" else (F32_W, dict(rtol=1e-4, atol=1e-3))
    assert_allclose(got_lw, np.asarray(want_lw), **tol_w)
    assert_allclose(got_d, np.asarray(want_d), **tol_k)


@pytest.mark.parametrize("fn", ["psislw", "sislw", "tislw"])
def test_public_weights_restore_shapes_and_names(fn):
    rng = np.random.default_rng(7)
    lw = rng.normal(size=(3, 4, 300))
    got_lw, got_d = getattr(tpl, fn)(lw)  # a 3-D array: the last axis is draws
    want_lw, want_d = getattr(jpl, fn)(lw)
    assert got_lw.shape == (3, 4, 300) and got_d.shape == (3, 4)
    assert_allclose(got_lw, np.asarray(want_lw), **F64)
    assert_allclose(got_d, np.asarray(want_d), **F64)

    got_lw, got_d = getattr(tpl, fn)(lw[0, 0])  # one row: a scalar diagnostic
    want_lw, want_d = getattr(jpl, fn)(lw[0, 0])
    assert got_lw.shape == (300,) and np.ndim(got_d) == 0
    assert_allclose(got_d, want_d, **F64)

    dims, coords = ("school", "chain", "draw"), {"school": np.array(["a", "b", "c"])}
    values = rng.normal(size=(3, 2, 150))
    got_lw, got_d = getattr(tpl, fn)(tpl.DataArray(values, dims, coords, "lw"))
    want_lw, want_d = getattr(jpl, fn)(jpl.DataArray(values, dims, coords, "lw"))
    assert got_lw.dims == want_lw.dims == ("school", "__sample__")
    assert got_lw.name == want_lw.name and got_d.name == want_d.name
    assert got_d.dims == ("school",) and list(got_d.coords["school"]) == ["a", "b", "c"]
    assert_allclose(got_lw.values, want_lw.values, **F64)
    assert_allclose(got_d.values, want_d.values, **F64)


def test_compute_importance_weights_messages():
    lw = np.zeros((2, 50))
    for pkg in (tpl, jpl):
        with pytest.raises(ValueError, match="Invalid method 'bad'. Must be one of: psis, sis, tis"):
            pkg.compute_importance_weights(lw, method="bad")
        with pytest.raises(ValueError, match="log_weights must be provided"):
            pkg.compute_importance_weights(None)
        with pytest.raises(ValueError, match="at least 2 draws per observation, got 1"):
            pkg.compute_importance_weights(np.zeros((3, 1)))
        with pytest.raises(ValueError, match="at least one dimension"):
            pkg.compute_importance_weights(np.float64(1.0))
    got = tpl.compute_importance_weights(lw + np.arange(50.0), method="TIS")
    want = jpl.compute_importance_weights(lw + np.arange(50.0), method="TIS")
    assert_allclose(got[0], np.asarray(want[0]), **F64)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_psislw_compact_public(dtype, precision):
    precision(dtype)
    lw = _rows(b=12, s=500, dtype=dtype)
    rng = np.random.default_rng(8)
    h = rng.normal(size=lw.shape).astype(dtype)
    got, want = tpl.psislw_compact(lw, reff=0.9), jpl.psislw_compact(lw, reff=0.9)
    assert isinstance(got, tpl.CompactWeights) and got.tail_idx.dtype == np.int32
    tol = F64 if dtype == "float64" else dict(rtol=1e-4, atol=2e-5)
    dense = got.densify(lw)
    assert_allclose(dense, want.densify(lw), **tol)
    assert_allclose(dense, tpl.psislw(lw, reff=0.9)[0], **tol)
    assert_allclose(got.pareto_k, want.pareto_k, **(F64 if dtype == "float64" else F32_K))
    assert_allclose(got.weighted_mean(h, lw), want.weighted_mean(h, lw), **tol)
    # variance and sd: see test_compact_weighted_mean_and_moments
    var_tol = dict(rtol=1e-10, atol=1e-10) if dtype == "float64" else dict(rtol=2e-3, atol=1e-5)
    (g_mean, g_var), (w_mean, w_var) = got.weighted_moments(h, lw), want.weighted_moments(h, lw)
    assert_allclose(g_mean, w_mean, **tol)
    assert_allclose(g_var, w_var, **var_tol)
    assert_allclose(got.weighted_sd(h, lw), want.weighted_sd(h, lw), **var_tol)
    probs = [0.05, 0.5, 0.95]
    q = got.weighted_quantile(h, lw, probs, chunk_rows=5)
    assert_allclose(q, want.weighted_quantile(h, lw, probs), **tol)
    assert_allclose(q, got.weighted_quantile(h, lw, probs), **F64)  # any chunking


def test_psislw_compact_needs_two_draws():
    with pytest.raises(ValueError, match="at least 2 draws"):
        tpl.psislw_compact(np.zeros((3, 1)))


def test_importance_sampling_result():
    res = tpl.psis.ImportanceSamplingResult(samples=np.zeros(3), log_weights=np.zeros(3))
    ref = jpl.psis.ImportanceSamplingResult(samples=np.zeros(3), log_weights=np.zeros(3))
    assert (res.pareto_k, res.warnings, res.method) == (ref.pareto_k, ref.warnings, ref.method)


# --------------------------------------------------------------------------
# apply_rowwise with outputs as wide as the input
# --------------------------------------------------------------------------


def test_apply_rowwise_budget_and_wide_outputs():
    from pyloo_tpu_torch.base import _WEIGHTS_EXTRA_BUFFERS
    from pyloo_tpu_torch.parallel.sharding import chunk_rows

    # loo()'s chunking stays as it was; a wide output takes its share
    assert chunk_rows(4_000, 4) == 131_072 and chunk_rows(4_000, 8) == 65_536
    assert chunk_rows(4_000, 4, extra_buffers=_WEIGHTS_EXTRA_BUFFERS) == 65_536
    assert chunk_rows(10**9, 8) == 1

    x = torch.arange(70.0).reshape(10, 7)
    y = torch.arange(10.0)[:, None]
    seen = []

    def kernel(a, b):
        seen.append(a.shape[0])
        assert a.data_ptr() >= x.data_ptr() and a.shape[1] == 7  # a view of x
        return a * 2 + b, a.sum(dim=1)

    wide, per_row = apply_rowwise(kernel, (x, y), chunk_bytes=4 * 4 * 7 * 4)
    assert seen == [4, 4, 2]
    assert torch.equal(wide, x * 2 + y) and torch.equal(per_row, x.sum(dim=1))
    assert wide.shape == (10, 7) and wide.is_contiguous()
    seen.clear()
    whole = apply_rowwise(kernel, (x, y))
    assert seen == [10] and torch.equal(whole[0], wide)
