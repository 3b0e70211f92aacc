"""``ops/expectations.py`` and ``e_loo`` of the port against ``pyloo_tpu``.

The four batch functions on rows with ties in ``x``, constant rows, uniform
weights and fewer draws than the k-hat's tail; ``e_loo`` for every type, with
weights or log-weights, through DataArrays and plain arrays.  Float64 within
rtol and atol 1e-12 (the variance within 1e-10: it divides a difference of
sums by ``1 - sum(w^2)``); float32 within rtol 1e-4 and atol 1e-5, k within
1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu.ops import expectations as jexp
from pyloo_tpu_torch.ops import expectations as texp
from pyloo_tpu_torch.parallel import apply_rowwise

from .torch_parity import F64, eight, set_precision, synthetic, values_of

F64_VAR = dict(rtol=1e-10, atol=1e-10)
F32 = dict(rtol=1e-4, atol=1e-5)


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


def _inputs(b=14, s=400, seed=0, dtype="float64"):
    """x and log-weights: ties in x with unequal weights (rows 0, 1), a
    constant x (row 2), uniform weights (row 3), one dominant weight (row 4),
    a heavy-tailed weight row (row 5)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s))
    lw = rng.normal(size=(b, s))
    x[0] = np.round(x[0], 1)
    x[1] = rng.integers(0, 4, size=s)
    x[2] = 1.5
    lw[3] = -np.log(s)
    lw[4] = -50.0
    lw[4, 7] = 0.0
    lw[5] = 3.0 * rng.standard_t(2, size=s)
    return x.astype(dtype), lw.astype(dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_weighted_mean_and_variance(dtype):
    x, lw = _inputs(dtype=dtype)
    tx, tlw, jx, jlw = torch.from_numpy(x), torch.from_numpy(lw), jnp.asarray(x), jnp.asarray(lw)
    tol = F64 if dtype == "float64" else F32
    assert_allclose(_np(texp.weighted_mean_batch(tx, tlw)), _np(jexp.weighted_mean_batch(jx, jlw)), **tol)
    got = _np(texp.weighted_variance_batch(tx, tlw))
    want = _np(jexp.weighted_variance_batch(jx, jlw))
    assert_allclose(got, want, **(F64_VAR if dtype == "float64" else dict(rtol=2e-3, atol=1e-5)))
    assert got[2] == 0.0 and got[4] == 0.0  # constant x; one dominant weight


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("probs", [[0.5], [0.05, 0.25, 0.5, 0.9, 0.999]])
def test_weighted_quantile(dtype, probs):
    x, lw = _inputs(dtype=dtype)
    got = texp.weighted_quantile_batch(torch.from_numpy(x), torch.from_numpy(lw), probs)
    want = jexp.weighted_quantile_batch(jnp.asarray(x), jnp.asarray(lw), np.asarray(probs))
    assert _np(got).shape == (x.shape[0], len(probs))
    assert_allclose(_np(got), _np(want), **(F64 if dtype == "float64" else F32))


def test_weighted_quantile_ties_need_the_stable_sort():
    """Two tied x values with unequal weights: the cumulative weight at the
    first of the run depends on the order inside it."""
    x = np.array([[0.0, 1.0, 1.0, 2.0, 1.0, 3.0]])
    lw = np.log(np.array([[0.1, 0.05, 0.4, 0.2, 0.15, 0.1]]))
    probs = [0.12, 0.3, 0.6]
    got = texp.weighted_quantile_batch(torch.from_numpy(x), torch.from_numpy(lw), probs)
    want = jexp.weighted_quantile_batch(jnp.asarray(x), jnp.asarray(lw), np.asarray(probs))
    assert_allclose(_np(got), _np(want), **F64)
    # by hand at p = 0.12: cumulative weights 0.1, 0.15 (index 1 first): 0 + (0.12 - 0.1) / 0.05
    assert_allclose(_np(got)[0, 0], 0.4, **F64)


def test_quantile_and_khat_do_not_depend_on_the_chunking():
    x, lw = _inputs(b=23, s=300, seed=1)
    tx, tlw = torch.from_numpy(x), torch.from_numpy(lw)
    probs = [0.1, 0.5, 0.9]
    whole = texp.weighted_quantile_batch(tx, tlw, probs)
    (chunked,) = apply_rowwise(
        lambda a, b: (texp.weighted_quantile_batch(a, b, probs),),
        (tx, tlw),
        chunk_bytes=4 * 10 * 300 * 8,
        extra_buffers=6,
    )
    assert torch.equal(whole, chunked)
    k_whole = texp.khat_batch(tx, tlw)
    (k_chunked,) = apply_rowwise(
        lambda a, b: (texp.khat_batch(a, b),), (tx, tlw), chunk_bytes=5 * 6 * 300 * 8, extra_buffers=2
    )
    assert torch.equal(k_whole, k_chunked)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("use_h", [True, False])
def test_khat_batch(dtype, use_h):
    x, lw = _inputs(dtype=dtype)
    x[6, 3] = np.inf  # a non-finite h falls back to the ratios' k
    got = texp.khat_batch(torch.from_numpy(x), torch.from_numpy(lw), use_h=use_h)
    want = jexp.khat_batch(jnp.asarray(x), jnp.asarray(lw), use_h=use_h)
    assert_allclose(_np(got), _np(want), **(F64 if dtype == "float64" else dict(rtol=0, atol=1e-3)))
    assert np.isinf(_np(got)[3])  # uniform weights: a constant ratio row


@pytest.mark.parametrize("s,tail_len", [(12, 20), (5, 20), (1, 20), (400, 5), (400, 60)])
def test_tail_khat_short_rows_and_tail_lengths(s, tail_len):
    rng = np.random.default_rng(2)
    values = np.exp(rng.normal(size=(6, s)))
    got = texp._tail_khat(torch.from_numpy(values), tail_len)
    want = jexp._tail_khat(jnp.asarray(values), tail_len)
    assert_allclose(_np(got), _np(want), **F64)


# --------------------------------------------------------------------------
# e_loo
# --------------------------------------------------------------------------


def _result_close(tres, jres, tol, k_tol):
    for field, t in (("value", tol), ("pareto_k", k_tol), ("khat_threshold", F64)):
        g, w = getattr(tres, field), getattr(jres, field)
        if hasattr(w, "dims"):
            assert g.dims == w.dims and g.name == w.name, field
        assert_allclose(values_of(g), values_of(w), err_msg=field, **t)
    # min_ss and the convergence rate are steep functions of k: compared
    # where pyloo_tpu's are finite, at the k tolerance times their slope
    for field in ("min_ss", "convergence_rate"):
        g, w = values_of(getattr(tres, field)), values_of(getattr(jres, field))
        assert np.array_equal(np.isfinite(g), np.isfinite(w))
        ok = np.isfinite(w)
        assert_allclose(g[ok], w[ok], rtol=1e-9 if tol is F64 else 5e-2, atol=1e-9)


@pytest.mark.parametrize("type_,probs", [("mean", None), ("variance", None), ("sd", None),
                                         ("quantile", [0.1, 0.5, 0.9]), ("quantile", 0.3)])
def test_e_loo_eight_schools(type_, probs):
    jid, tid = eight()
    jll = jid.log_likelihood.obs.stack(__sample__=("chain", "draw"))
    tll = tid.log_likelihood.obs.stack(__sample__=("chain", "draw"))
    jlw, _ = jpl.psislw(-jll)
    tlw, _ = tpl.psislw(-tll)
    kwargs = dict(group="posterior", var_name="theta", type=type_, probs=probs)
    jres = jpl.e_loo(jid, log_weights=jlw, log_ratios=-jll, **kwargs)
    tres = tpl.e_loo(tid, log_weights=tlw, log_ratios=-tll, **kwargs)
    tol = F64_VAR if type_ in ("variance", "sd") else F64
    _result_close(tres, jres, tol, F64)
    if type_ == "quantile":
        assert tres.value.dims == ("school", "quantile")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("type_", ["mean", "variance", "quantile"])
def test_e_loo_posterior_predictive(dtype, type_, precision):
    precision(dtype)
    jid, tid = synthetic(obs_shape=(3, 4), seed=3, predictive=True, tail=True)
    jll = jid.log_likelihood.y.stack(__sample__=("chain", "draw"))
    tll = tid.log_likelihood.y.stack(__sample__=("chain", "draw"))
    jlw, _ = jpl.psislw(-jll)
    tlw, _ = tpl.psislw(-tll)
    probs = [0.25, 0.75] if type_ == "quantile" else None
    # no log_ratios: the diagnostic is fitted to the smoothed weights
    jres = jpl.e_loo(jid, log_weights=jlw, type=type_, probs=probs)
    tres = tpl.e_loo(tid, log_weights=tlw, type=type_, probs=probs)
    assert tres.pareto_k.dims == ("obs_0", "obs_1")
    if dtype == "float64":
        _result_close(tres, jres, F64_VAR if type_ == "variance" else F64, F64)
    else:
        _result_close(tres, jres, dict(rtol=2e-3, atol=1e-4), dict(rtol=0, atol=2e-3))


def test_e_loo_weights_and_plain_arrays():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 300))
    lw = rng.normal(size=(5, 300))
    w = np.exp(lw - lw.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    jx = jpl.DataArray(x, ("obs", "__sample__"))
    tx = tpl.DataArray(x, ("obs", "__sample__"))
    for kwargs in (dict(weights=w), dict(log_weights=lw)):
        jres, tres = jpl.e_loo(jx, **kwargs), tpl.e_loo(tx, **kwargs)
        _result_close(tres, jres, F64, F64)
    jres = jpl.e_loo(jx, log_weights=lw, log_ratios=jpl.DataArray(lw * 1.5, ("obs", "__sample__")))
    tres = tpl.e_loo(tx, log_weights=lw, log_ratios=tpl.DataArray(lw * 1.5, ("obs", "__sample__")))
    _result_close(tres, jres, F64, F64)
    for pkg, xd in ((jpl, jx), (tpl, tx)):  # ratios as a bare array have no sample dim
        with pytest.raises(ValueError, match="__sample__ dimension"):
            pkg.e_loo(xd, log_weights=lw, log_ratios=lw * 1.5)
    jres = jpl.e_loo(jx, weights=jpl.DataArray(w, ("obs", "draws")))
    tres = tpl.e_loo(tx, weights=tpl.DataArray(w, ("obs", "draws")))
    _result_close(tres, jres, F64, F64)


def test_e_loo_broadcasts_a_scalar_parameter():
    jid, tid = synthetic(seed=5)
    jll = jid.log_likelihood.y.stack(__sample__=("chain", "draw"))
    tll = tid.log_likelihood.y.stack(__sample__=("chain", "draw"))
    jres = jpl.e_loo(jid, group="posterior", var_name="mu", log_weights=jpl.psislw(-jll)[0])
    tres = tpl.e_loo(tid, group="posterior", var_name="mu", log_weights=tpl.psislw(-tll)[0])
    assert values_of(tres.value).shape == (12,)
    _result_close(tres, jres, F64, F64)


def test_e_loo_errors():
    jid, tid = synthetic(seed=6, predictive=True)
    lw = np.zeros((12, 600))
    for pkg, idata in ((jpl, jid), (tpl, tid)):
        with pytest.raises(ValueError, match="type must be"):
            pkg.e_loo(idata, log_weights=lw, type="median")
        with pytest.raises(ValueError, match="probs must be provided"):
            pkg.e_loo(idata, log_weights=lw, type="quantile")
        with pytest.raises(ValueError, match="probs must be between 0 and 1"):
            pkg.e_loo(idata, log_weights=lw, type="quantile", probs=[0.5, 1.0])
        with pytest.raises(ValueError, match="Either weights or log_weights"):
            pkg.e_loo(idata)
        with pytest.raises(ValueError, match="does not have a prior group"):
            pkg.e_loo(idata, group="prior", log_weights=lw)
        with pytest.raises(ValueError, match="Multiple variables found in posterior"):
            pkg.e_loo(idata, group="posterior", log_weights=lw)
        with pytest.raises(ValueError, match="Variable 'nu' not found"):
            pkg.e_loo(idata, var_name="nu", log_weights=lw)
        with pytest.raises(ValueError, match="x has 600 draws but log_weights has 50"):
            pkg.e_loo(idata, log_weights=np.zeros((12, 50)))
        with pytest.raises(ValueError, match="must have"):
            pkg.e_loo(idata, log_weights=np.zeros((7, 600)))


@pytest.mark.parametrize("with_x", [True, False])
def test_compute_pareto_k_and_k_hat(with_x):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(6, 250))
    lr = 2.0 * rng.normal(size=(6, 250))
    xa = x if with_x else None
    assert_allclose(tpl.compute_pareto_k(xa, lr), jpl.compute_pareto_k(xa, lr), **F64)
    assert_allclose(tpl.compute_pareto_k(xa, lr, tail_len=40), jpl.compute_pareto_k(xa, lr, tail_len=40), **F64)
    one = tpl.compute_pareto_k(None if xa is None else x[0], lr[0])
    assert isinstance(one, float)
    assert_allclose(one, jpl.compute_pareto_k(None if xa is None else x[0], lr[0]), **F64)
    assert_allclose(tpl.k_hat(None if xa is None else x[1], lr[1]), jpl.k_hat(None if xa is None else x[1], lr[1]), **F64)
    dims, coords = ("obs", "__sample__"), {"obs": np.arange(6)}
    got = tpl.compute_pareto_k(
        tpl.DataArray(x, dims, coords) if with_x else None, tpl.DataArray(lr, dims, coords)
    )
    want = jpl.compute_pareto_k(
        jpl.DataArray(x, dims, coords) if with_x else None, jpl.DataArray(lr, dims, coords)
    )
    assert got.name == want.name == "pareto_k" and got.dims == want.dims
    assert_allclose(got.values, want.values, **F64)
    with pytest.raises(ValueError, match="tail_len must be at least 5"):
        tpl.compute_pareto_k(xa, lr, tail_len=4)


@pytest.mark.parametrize("k", [np.nan, -0.2, 0.0, 0.3, 0.5, 0.7, 1.0, 1.4])
def test_pareto_reliability_measures(k):
    import importlib

    je = importlib.import_module("pyloo_tpu.e_loo")
    te = importlib.import_module("pyloo_tpu_torch.e_loo")

    assert te._pareto_min_ss(k) == je._pareto_min_ss(k)
    assert te._pareto_convergence_rate(k, 4000) == je._pareto_convergence_rate(k, 4000)
    assert te._pareto_khat_threshold(4000) == je._pareto_khat_threshold(4000)


_K_EDGES = [np.nan, -0.2, 0.0, 0.3, 0.5, 0.7, 1.0, 1.4]


@pytest.mark.parametrize("kind", ["edges", "random"])
def test_vectorized_reliability_measures_equal_the_scalar_forms(kind):
    import importlib

    te = importlib.import_module("pyloo_tpu_torch.e_loo")
    if kind == "edges":
        k = np.array(_K_EDGES)
    else:
        k = np.random.default_rng(5).uniform(-0.5, 1.5, size=500)
        k[::50] = np.nan
    min_ss = te._min_ss_vectorized(k)
    rate = te._convergence_rate_vectorized(k, 4000)
    want_ss = np.array([te._pareto_min_ss(v) for v in k])
    want_rate = np.array([te._pareto_convergence_rate(v, 4000) for v in k])
    # inf exactly where the scalar form gives inf; the finite values equal on
    # the edges and within an ulp or two elsewhere (numpy's array pow is not
    # Python's scalar pow: measured max |d| 8.9e-16 on the random vector)
    assert np.array_equal(np.isinf(min_ss), np.isinf(want_ss))
    assert np.isinf(min_ss[np.isnan(k) | (k >= 1)]).all()
    finite = np.isfinite(want_ss)
    if kind == "edges":
        assert np.array_equal(min_ss, want_ss) and np.array_equal(rate, want_rate)
    assert_allclose(min_ss[finite], want_ss[finite], rtol=1e-14, atol=0)
    assert_allclose(rate, want_rate, rtol=1e-14, atol=1e-15)
