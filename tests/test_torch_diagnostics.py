"""``diagnostics``, ``loo_predictive_metric``, ``generic_elpd.elpd`` and
``loo_group`` of the port against ``pyloo_tpu`` on the same numpy inputs.

Float64 within rtol and atol 1e-12 (the ESS, a reciprocal of a sum of
squares of thousands of weights, within rtol 1e-12 alone), reports byte for
byte.  Float32: stated per test.
"""

import warnings

import numpy as np
import pytest
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl

from .torch_parity import F64, assert_same_rows, eight, set_precision, synthetic


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


# --------------------------------------------------------------------------
# diagnostics.py
# --------------------------------------------------------------------------


def test_pareto_k_accessors():
    jid, tid = synthetic(seed=0, tail=True)
    jres = _quiet(jpl.loo, jid, pointwise=True)
    tres = _quiet(tpl.loo, tid, pointwise=True)
    assert_allclose(tpl.pareto_k_values(tres), jpl.pareto_k_values(jres), **F64)
    for threshold in (None, 0.3, 0.0):
        assert np.array_equal(tpl.pareto_k_ids(tres, threshold), jpl.pareto_k_ids(jres, threshold))
        ttab, jtab = tpl.pareto_k_table(tres, threshold), jpl.pareto_k_table(jres, threshold)
        assert str(ttab) == str(jtab)
        assert np.array_equal(ttab.counts, jtab.counts) and ttab.bins == jtab.bins
    with pytest.raises(ValueError, match="no pointwise Pareto k"):
        tpl.pareto_k_values(_quiet(tpl.loo, tid))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_psis_ess_and_mcse(dtype, precision):
    precision(dtype)
    jid, tid = synthetic(obs_shape=(3, 5), seed=1, tail=True)
    tol = dict(rtol=1e-12) if dtype == "float64" else dict(rtol=1e-3)
    assert_allclose(tpl.psis_ess_values(tid), jpl.psis_ess_values(jid), **tol)
    assert_allclose(tpl.psis_ess_values(tid, reff=0.6), jpl.psis_ess_values(jid, reff=0.6), **tol)
    tol = F64 if dtype == "float64" else dict(rtol=1e-3, atol=1e-5)
    got, want = tpl.mcse_loo(tid, pointwise=True), jpl.mcse_loo(jid, pointwise=True)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert_allclose(got, want, **tol)
    assert_allclose(tpl.mcse_loo(tid), jpl.mcse_loo(jid), **tol)


def test_mcse_loo_reproduces_loo_from_the_weights():
    """The readers hold the weights to account: elpd_i from psislw's weights
    is loo()'s pointwise row, and k > 0.7 rows give NaN."""
    jid, tid = synthetic(seed=2, tail=True)
    ll = tid.log_likelihood.y.stack(__sample__=("chain", "draw"))
    res = _quiet(tpl.loo, tid, pointwise=True)
    from pyloo_tpu_torch._common import compute_reff

    lw, k = tpl.psislw(-ll, reff=compute_reff(tid, None, 600))
    elpd_i = np.log(np.exp(lw.values + ll.values).sum(axis=1))
    assert_allclose(elpd_i, res.loo_i.values, **F64)
    assert_allclose(k.values, res.pareto_k.values, **F64)
    mcse = tpl.mcse_loo(tid, pointwise=True)
    assert np.array_equal(np.isnan(mcse), res.pareto_k.values > 0.7)


@pytest.mark.parametrize("explicit", [False, True])
def test_loo_pit(explicit):
    jid, tid = synthetic(seed=3, predictive=True)
    if explicit:
        y = np.asarray(jid.observed_data.y.values)
        y_hat = np.asarray(jid.posterior_predictive.y.values)  # (chain, draw, obs)
        got, want = tpl.loo_pit(tid, y=y, y_hat=y_hat), jpl.loo_pit(jid, y=y, y_hat=y_hat)
        flat = y_hat.reshape(-1, y_hat.shape[-1]).T
        assert_allclose(tpl.loo_pit(tid, y=y, y_hat=flat).values, want.values, **F64)
    else:
        got, want = tpl.loo_pit(tid), jpl.loo_pit(jid)
    assert got.dims == want.dims == ("obs",) and got.name == want.name == "loo_pit"
    assert_allclose(got.values, want.values, **F64)
    assert ((got.values >= 0) & (got.values <= 1 + 1e-12)).all()


def test_loo_pit_errors():
    _, tid = synthetic(seed=4)
    with pytest.raises(ValueError, match="needs `y`"):
        tpl.loo_pit(tid)
    with pytest.raises(ValueError, match="needs `y_hat`"):
        tpl.loo_pit(tid, y=np.zeros(12))
    with pytest.raises(ValueError, match="does not match the"):
        tpl.loo_pit(tid, y=np.zeros(12), y_hat=np.zeros((12, 7)))
    with pytest.raises(ValueError, match="y has 5 observations"):
        tpl.loo_pit(tid, y=np.zeros(5), y_hat=np.zeros((12, 600)))


def test_relative_eff():
    jid, tid = eight()
    assert_allclose(tpl.relative_eff(tid), jpl.relative_eff(jid), **F64)
    rng = np.random.default_rng(5)
    draws = rng.normal(size=(4, 200, 3)).cumsum(axis=1) * 0.1 + rng.normal(size=(4, 200, 3))
    assert_allclose(tpl.relative_eff(draws), jpl.relative_eff(draws), **F64)
    assert_allclose(tpl.relative_eff(draws[:, :, 0]), jpl.relative_eff(draws[:, :, 0]), **F64)
    assert_allclose(
        tpl.relative_eff({"a": draws, "b": draws[:, :, 0]}),
        jpl.relative_eff({"a": draws, "b": draws[:, :, 0]}), **F64,
    )
    da = tpl.DataArray(draws, ("chain", "draw", "obs"))
    assert_allclose(tpl.relative_eff(da), jpl.relative_eff(draws), **F64)
    with pytest.raises(ValueError, match="method must be 'mean'"):
        tpl.relative_eff(draws, method="median")
    with pytest.raises(ValueError, match="expects \\(chain, draw"):
        tpl.relative_eff(draws[0, :, 0])


# --------------------------------------------------------------------------
# loo_predictive_metric
# --------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["mae", "mse", "rmse"])
def test_loo_predictive_metric_continuous(metric):
    jid, tid = synthetic(seed=6, predictive=True, tail=True)
    y = np.asarray(jid.observed_data.y.values)
    got = tpl.loo_predictive_metric(tid, y, metric=metric, r_eff=0.8)
    want = jpl.loo_predictive_metric(jid, y, metric=metric, r_eff=0.8)
    assert set(got) == {"estimate", "se"}
    assert_allclose([got["estimate"], got["se"]], [want["estimate"], want["se"]], **F64)


@pytest.mark.parametrize("metric", ["acc", "balanced_acc"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_loo_predictive_metric_binary(metric, dtype, precision):
    precision(dtype)
    rng = np.random.default_rng(7)
    p = rng.uniform(0.05, 0.95, size=(2, 200, 30))
    y = (rng.uniform(size=30) < 0.5).astype(float)
    ll = np.where(y == 1, np.log(p), np.log1p(-p))
    groups = dict(posterior={"b": rng.normal(size=(2, 200))}, log_likelihood={"y": ll},
                  posterior_predictive={"y": p})
    got = tpl.loo_predictive_metric(tpl.from_dict(**groups), y, metric=metric)
    want = jpl.loo_predictive_metric(jpl.from_dict(**groups), y, metric=metric)
    assert_allclose([got["estimate"], got["se"]], [want["estimate"], want["se"]], **F64)


def test_loo_predictive_metric_errors():
    jid, tid = synthetic(seed=8, predictive=True)
    y = np.zeros(12)
    for pkg, idata in ((jpl, jid), (tpl, tid)):
        with pytest.raises(ValueError, match="Invalid metric: r2"):
            pkg.loo_predictive_metric(idata, y, metric="r2")
        with pytest.raises(ValueError, match="Length of y \\(3\\)"):
            pkg.loo_predictive_metric(idata, y[:3])
        with pytest.raises(ValueError, match="does not have a prior_predictive group"):
            pkg.loo_predictive_metric(idata, y, group="prior_predictive")
        with pytest.raises(ValueError, match="Variable 'z' not found in log_likelihood"):
            pkg.loo_predictive_metric(idata, y, log_lik_var_name="z")
        with pytest.raises(ValueError, match="y must contain values between 0 and 1"):
            pkg.loo_predictive_metric(idata, y + 2.0, metric="acc")


# --------------------------------------------------------------------------
# generic_elpd.elpd
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scale", ["log", "negative_log", "deviance"])
@pytest.mark.parametrize("pointwise", [False, True])
def test_generic_elpd(scale, pointwise):
    jid, tid = synthetic(obs_shape=(4, 3), seed=9)
    jres, tres = jpl.elpd(jid, scale=scale, pointwise=pointwise), tpl.elpd(tid, scale=scale, pointwise=pointwise)
    assert_same_rows(tres, jres)
    assert str(tres) == str(jres)


def test_generic_elpd_float32_and_nan(precision):
    precision("float32")
    jid, tid = synthetic(seed=10)
    # pyloo_tpu computes this function in float64 whatever the precision;
    # the port follows device.precision: float32 sums of 600 terms
    assert_same_rows(tpl.elpd(tid, pointwise=True), jpl.elpd(jid, pointwise=True), dict(rtol=1e-5, atol=1e-5))
    tid.log_likelihood["y"].values[0, 0, 0] = np.nan
    with pytest.warns(UserWarning, match="ignored in the ELPD calculation"):
        tpl.elpd(tid)


# --------------------------------------------------------------------------
# loo_group
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["psis", "sis", "tis"])
@pytest.mark.parametrize("pointwise", [False, True])
def test_loo_group_eight_schools(method, pointwise):
    jid, tid = eight()
    groups = np.array(["a", "a", "b", "c", "c", "c", "d", "b"])
    jres = _quiet(jpl.loo_group, jid, groups, pointwise=pointwise, method=method)
    tres = _quiet(tpl.loo_group, tid, groups, pointwise=pointwise, method=method)
    assert_same_rows(tres, jres)
    assert str(tres) == str(jres)
    if pointwise:
        assert list(tres.logo_i.coords["group"]) == ["a", "b", "c", "d"]


@pytest.mark.parametrize("scale", ["negative_log", "deviance"])
def test_loo_group_scales_and_a_high_k_report(scale):
    jid, tid = synthetic(obs_shape=(24,), seed=11, tail=True)
    groups = np.arange(24) % 5
    seen = {}
    for name, pkg, idata in (("jax", jpl, jid), ("torch", tpl, tid)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = pkg.loo_group(idata, groups, pointwise=True, scale=scale)
            seen[name] = (res, sorted(str(w.message) for w in caught))
    assert seen["torch"][1] == seen["jax"][1]
    assert any("groups" in m for m in seen["torch"][1])  # the k table is printed
    assert_same_rows(seen["torch"][0], seen["jax"][0])
    assert str(seen["torch"][0]) == str(seen["jax"][0])


def test_loo_group_float32_takes_the_exact_scorer(precision):
    precision("float32")
    jid, tid = synthetic(obs_shape=(20,), seed=12)
    groups = np.arange(20) // 4
    jres = _quiet(jpl.loo_group, jid, groups, pointwise=True)
    tres = _quiet(tpl.loo_group, tid, groups, pointwise=True)
    # sums of 4 float32 rows, then the float32 signed-log fit in both packages
    assert_same_rows(tres, jres, dict(rtol=1e-4, atol=1e-3))


def test_loo_group_errors_and_warnings():
    jid, tid = synthetic(seed=13)
    for pkg, idata in ((jpl, jid), (tpl, tid)):
        with pytest.raises(ValueError, match="Length of group_ids \\(3\\)"):
            pkg.loo_group(idata, np.zeros(3))
        with pytest.raises(ValueError, match="Invalid method 'bad'"):
            pkg.loo_group(idata, np.zeros(12), method="bad")
    tid.log_likelihood["y"].values[0, 0, 0] = np.nan
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tpl.loo_group(tid, np.arange(12) % 3, method="tis")
    messages = [str(w.message) for w in caught]
    assert any("ignored in the LOGO calculation" in m for m in messages)
    assert any("Using TIS for LOGO computation" in m for m in messages)


# --------------------------------------------------------------------------
# the report kinds that wait for their estimators
# --------------------------------------------------------------------------


@pytest.mark.parametrize("first,extra", [("elpd_kfold", []), ("elpd_loo", ["subsampling_SE"])],
                         ids=["elpd_kfold", "subsample"])
def test_other_report_kinds_say_they_are_not_rendered(first, extra):
    rows = [first, "se", "n_samples", "n_data_points", "warning"] + extra
    values = [0.0, 1.0, 10, 5, False] + [0.1] * len(extra)
    if first == "elpd_kfold":
        # the kfold kind came with loo_kfold: rendered as pyloo_tpu renders it
        rows = rows + ["p_kfold", "p_kfold_se", "K", "stratified"]
        values = values + [1.5, 0.5, 4, True]
        tres, jres = tpl.ELPDData(values, rows), jpl.ELPDData(data=values, index=rows)
        for res in (tres, jres):
            res.K, res.stratified = 4, True
        assert str(tres) == str(jres)
        assert "4-fold cross-validation" in str(tres)
        with pytest.raises(NotImplementedError, match="non-factorised kind"):
            str(tpl.ELPDData([0.0, 1.0], ["elpd_nonfactor", "se"]))
        return
    # the subsample kind came with loo_subsample: rendered as pyloo_tpu renders it
    rows, values = rows + ["p_loo", "subsample_size"], values + [2.5, 4]
    assert str(tpl.ELPDData(values, rows)) == str(jpl.ELPDData(data=values, index=rows))
