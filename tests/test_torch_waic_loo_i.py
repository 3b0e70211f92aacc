"""``waic`` and ``loo_i`` of the port against ``pyloo_tpu`` on the same inputs.

Every scale, pointwise on and off, the NaN and inf warnings, the printed
report byte for byte, and ``loo_i(i)`` against row i of
``loo(pointwise=True)``.  Float64 within rtol and atol 1e-12; float32 within
rtol and atol 1e-5 on the elpd rows and 1e-3 on k (the float32 fits of the
two packages differ by an ulp in their transcendentals).
"""

import warnings

import numpy as np
import pytest
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl

from .torch_parity import F64, assert_same_rows, eight, set_precision, synthetic

F32 = dict(rtol=1e-5, atol=1e-5)


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


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


@pytest.mark.parametrize("scale", ["log", "negative_log", "deviance"])
@pytest.mark.parametrize("pointwise", [False, True])
def test_waic_eight_schools(scale, pointwise):
    jid, tid = eight()
    jres = _quiet(jpl.waic, jid, pointwise=pointwise, scale=scale)
    tres = _quiet(tpl.waic, tid, pointwise=pointwise, scale=scale)
    assert_same_rows(tres, jres)
    assert str(tres) == str(jres)
    assert repr(tres) == str(jres)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_waic_synthetic_two_obs_dims(dtype, precision):
    precision(dtype)
    jid, tid = synthetic(obs_shape=(4, 5), seed=1)
    jres, tres = _quiet(jpl.waic, jid, pointwise=True), _quiet(tpl.waic, tid, pointwise=True)
    assert tres.waic_i.dims == ("obs_0", "obs_1")
    assert_same_rows(tres, jres, F64 if dtype == "float64" else dict(rtol=1e-4, atol=1e-4))
    if dtype == "float64":
        assert str(tres) == str(jres)


def test_waic_warnings_nan_inf_and_variance():
    jid, tid = synthetic(seed=2, tail=True)
    for idata in (jid, tid):
        v = idata.log_likelihood["y"].values
        v[0, 0, 0] = np.nan
        v[0, 1, 1] = np.inf
        v[1, 2, 2] = -np.inf
    seen = {}
    for name, pkg, idata in (("jax", jpl, jid), ("torch", tpl, tid)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            seen[name] = (pkg.waic(idata, pointwise=True), sorted(str(w.message) for w in caught))
    assert seen["torch"][1] == seen["jax"][1]
    assert any("NaN values detected" in m and "WAIC" in m for m in seen["torch"][1])
    assert any("Infinite values detected" in m for m in seen["torch"][1])
    assert any("exceeds 0.4" in m for m in seen["torch"][1])
    # the replaced +-1e10 values make variances of ~1e17: relative agreement
    assert_same_rows(seen["torch"][0], seen["jax"][0], dict(rtol=1e-12, atol=1e-6))
    assert seen["torch"][0].warning and "There has been a warning" in str(seen["torch"][0])
    # the caller's array is not written to
    assert np.isnan(tid.log_likelihood["y"].values[0, 0, 0])


def test_waic_pointwise_all_equal_warns():
    ll = np.full((2, 50, 4), -1.0)
    tid = tpl.from_dict(log_likelihood={"y": ll})
    with pytest.warns(UserWarning, match="point-wise WAIC is the same"):
        tpl.waic(tid, pointwise=True)
    with pytest.raises(TypeError, match="Valid scale values"):
        tpl.waic(tid, scale="bits")


@pytest.mark.parametrize("method", ["psis", "sis", "tis"])
@pytest.mark.parametrize("scale", ["log", "negative_log", "deviance"])
@pytest.mark.parametrize("pointwise", [False, True])
def test_loo_i_eight_schools(method, scale, pointwise):
    jid, tid = eight()
    jres = _quiet(jpl.loo_i, 5, jid, pointwise=pointwise, scale=scale, method=method)
    tres = _quiet(tpl.loo_i, 5, tid, pointwise=pointwise, scale=scale, method=method)
    assert_same_rows(tres, jres)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_loo_i_is_row_i_of_loo(dtype, precision):
    precision(dtype)
    jid, tid = synthetic(obs_shape=(3, 4), seed=3, tail=True)
    full = _quiet(tpl.loo, tid, pointwise=True)
    tol, k_tol = (F64, F64) if dtype == "float64" else (F32, dict(rtol=0, atol=1e-3))
    for i in (0, 5, 11):
        tres = _quiet(tpl.loo_i, i, tid, pointwise=True)
        jres = _quiet(jpl.loo_i, i, jid, pointwise=True)
        assert_same_rows(tres, jres, dict(rtol=1e-4, atol=1e-3) if dtype == "float32" else F64)
        assert_allclose(tres["elpd_loo"], full.loo_i.values.ravel()[i], **tol)
        assert_allclose(tres["pareto_k"][0], full.pareto_k.values.ravel()[i], **k_tol)


def test_loo_i_reads_the_row_of_a_lazily_stacked_matrix():
    # (chain, draw, obs...) stacks lazily; an explicit (obs, chain, draw)
    # layout does not: both give the same row
    rng = np.random.default_rng(4)
    ll = rng.normal(-1, 0.5, size=(2, 100, 3, 2))
    lazy = tpl.from_dict(log_likelihood={"y": ll})
    moved = tpl.inference_data_from_numpy(
        {"log_likelihood": {"y": (np.moveaxis(ll, (2, 3), (0, 1)), ("a", "b", "chain", "draw"), {})}}
    )
    for i in range(6):
        a = tpl.loo_i(i, lazy, reff=1.0, pointwise=True)
        b = tpl.loo_i(i, moved, reff=1.0, pointwise=True)
        assert a["elpd_loo"] == b["elpd_loo"] and a["pareto_k"][0] == b["pareto_k"][0]
    row = ll.reshape(200, 6)[:, 4]
    want = jpl.loo_i(4, jpl.from_dict(log_likelihood={"y": ll}), reff=1.0)
    assert_allclose(tpl.loo_i(4, lazy, reff=1.0)["elpd_loo"], want["elpd_loo"], **F64)
    assert row.shape == (200,)


def test_loo_i_warnings_and_errors():
    jid, tid = synthetic(seed=5, tail=True)
    for idata in (jid, tid):
        idata.log_likelihood["y"].values[0, 0, 1] = np.nan
    seen = {}
    for name, pkg, idata in (("jax", jpl, jid), ("torch", tpl, tid)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = pkg.loo_i(1, idata, pointwise=True, method="sis")
            seen[name] = (res, sorted(str(w.message) for w in caught))
    assert seen["torch"][1] == seen["jax"][1]
    assert any("NaN values detected" in m for m in seen["torch"][1])
    assert any("Using SIS for LOO computation" in m for m in seen["torch"][1])
    assert_same_rows(seen["torch"][0], seen["jax"][0])

    for pkg, idata in ((jpl, jid), (tpl, tid)):
        with pytest.raises(ValueError, match="single integer index"):
            pkg.loo_i([1, 2], idata)
        with pytest.raises(TypeError, match="must be an integer"):
            pkg.loo_i("first", idata)
        with pytest.raises(IndexError, match="out of bounds for log likelihood array with 12"):
            pkg.loo_i(12, idata)
        with pytest.raises(ValueError, match="Invalid method 'bad'"):
            pkg.loo_i(0, idata, method="bad")


def test_loo_i_high_k_warns_like_pyloo_tpu():
    rng = np.random.default_rng(6)
    ll = rng.normal(-1, 0.5, size=(1, 400, 2))
    ll[0, :, 0] = -np.abs(3.0 * rng.standard_cauchy(400))  # a very heavy tail
    jid, tid = jpl.from_dict(log_likelihood={"y": ll}), tpl.from_dict(log_likelihood={"y": ll})
    with pytest.warns(UserWarning, match="for 1 observations"):
        tres = tpl.loo_i(0, tid, reff=1.0, pointwise=True)
    jres = _quiet(jpl.loo_i, 0, jid, reff=1.0, pointwise=True)
    assert tres.warning and tres["pareto_k"][0] > tres["good_k"]
    assert_same_rows(tres, jres)
