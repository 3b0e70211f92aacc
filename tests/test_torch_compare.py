"""``pyloo_tpu_torch.loo_compare`` and its weights against ``pyloo_tpu`` on the CPU.

Three seeded models (40 observations, 2 x 250 draws, ``torch_parity.synthetic``)
go through both packages.  The port's :class:`CompareTable` is held to
``pyloo_tpu``'s ``DataFrame`` column by column, and its ``to_pandas()`` to the
same frame.  Tolerances: float64 rtol/atol 1e-12 where both packages score
the raw data (their ``loo``/``waic`` agree to ~1e-14); where both are given
the same precomputed numbers every column, the SLSQP weights included, is
equal within 1e-15 (both run the same scipy call on equal inputs).  The EM
stacking solver on the device is held to ``pyloo_tpu.ops.stacking`` in its
weights (1e-12) and its iteration count (equal).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu import compare as jcompare
from pyloo_tpu.ops import stacking as jstacking
from pyloo_tpu_torch import compare as tcompare
from pyloo_tpu_torch.ops import stacking as tstacking

from .torch_parity import F64, assert_same_table, both, synthetic

SAME = dict(rtol=1e-15, atol=1e-15)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


def _three():
    models = [synthetic(obs_shape=(40,), draws=250, seed=s) for s in (1, 2, 3)]
    return ({f"m{i}": m[0] for i, m in enumerate(models)},
            {f"m{i}": m[1] for i, m in enumerate(models)})


JAX_MODELS, TORCH_MODELS = _three()


def _quiet(fn, *args, **kwargs):
    """``fn(...)`` and the messages of the warnings it raised."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, [str(w.message) for w in caught]


def port_elpd(jres):
    """A pyloo_tpu ELPDData as the port's, with the same numbers."""
    values = []
    for key in jres.index:
        v = jres[key]
        if hasattr(v, "dims"):
            v = tpl.DataArray(np.asarray(v.values), v.dims, dict(v.coords), v.name)
        values.append(v)
    return tpl.ELPDData(values, list(jres.index))


def _both_compare(jdict, tdict, **kw):
    jres, jmsg = _quiet(jpl.loo_compare, jdict, **kw)
    tres, tmsg = _quiet(tpl.loo_compare, tdict, **kw)
    assert tmsg == jmsg
    return tres, jres


@pytest.mark.parametrize("method", ["stacking", "bb-pseudo-bma", "pseudo-bma"])
@pytest.mark.parametrize("scale", ["log", "negative_log", "deviance"])
@pytest.mark.parametrize("ic", ["loo", "waic"])
def test_raw_models_match(ic, scale, method):
    tres, jres = _both_compare(JAX_MODELS, TORCH_MODELS, ic=ic, scale=scale,
                               method=method, seed=5)
    assert_same_table(tres, jres, F64)


_PRECOMPUTED = {}


def _precomputed(ic, scale):
    """Each model scored once by pyloo_tpu, and the same numbers for the port."""
    if (ic, scale) not in _PRECOMPUTED:
        fn = jpl.loo if ic == "loo" else jpl.waic
        jres = {name: _quiet(fn, idata, pointwise=True, scale=scale)[0]
                for name, idata in JAX_MODELS.items()}
        _PRECOMPUTED[ic, scale] = jres, {n: port_elpd(r) for n, r in jres.items()}
    return _PRECOMPUTED[ic, scale]


@pytest.mark.parametrize("method", ["stacking", "bb-pseudo-bma", "pseudo-bma"])
@pytest.mark.parametrize("scale", ["log", "negative_log", "deviance"])
@pytest.mark.parametrize("ic", ["loo", "waic"])
def test_precomputed_results_give_the_same_table(ic, scale, method):
    jdict, tdict = _precomputed(ic, scale)
    tres, jres = _both_compare(jdict, tdict, method=method, seed=11)
    assert_same_table(tres, jres, SAME)


def test_mixed_precomputed_and_raw_entries():
    jdict, tdict = _precomputed("loo", "log")
    jmix = {"m0": jdict["m0"], "m1": JAX_MODELS["m1"], "m2": jdict["m2"]}
    tmix = {"m0": tdict["m0"], "m1": TORCH_MODELS["m1"], "m2": tdict["m2"]}
    tres, jres = _both_compare(jmix, tmix)
    assert_same_table(tres, jres, F64)


def test_mixed_ic_and_scale_raise_as_pyloo_tpu():
    jloo, tloo = _precomputed("loo", "log")
    jwaic, twaic = _precomputed("waic", "log")
    jdev, tdev = _precomputed("loo", "deviance")
    for jd, td in [({"a": jloo["m0"], "b": jwaic["m1"]}, {"a": tloo["m0"], "b": twaic["m1"]}),
                   ({"a": jloo["m0"], "b": jdev["m1"]}, {"a": tloo["m0"], "b": tdev["m1"]})]:
        with pytest.raises(ValueError) as jerr:
            jpl.loo_compare(jd)
        with pytest.raises(ValueError) as terr:
            tpl.loo_compare(td)
        assert str(terr.value) == str(jerr.value)


def test_not_pointwise_and_argument_errors():
    eight = tpl.load_example_data("centered_eight")
    res = tpl.loo(eight)
    with pytest.raises(ValueError, match="pointwise=True"):
        tpl.loo_compare({"a": res, "b": res})
    with pytest.raises(TypeError, match="must be a dictionary"):
        tpl.loo_compare([eight, eight])
    with pytest.raises(ValueError, match="at least two models"):
        tpl.loo_compare({"a": eight})
    with pytest.raises(ValueError, match="Scale must be"):
        tpl.loo_compare({"a": eight, "b": eight}, scale="bad")
    with pytest.raises(ValueError, match="Method must be"):
        tpl.loo_compare({"a": eight, "b": eight}, method="bad")
    with pytest.raises(ValueError, match="ic must be"):
        tpl.loo_compare({"a": eight, "b": eight}, ic="bad")


def test_kfold_and_subsampling_raise_with_their_roadmap_items():
    # kfold on raw data refits model wrappers (tests/test_torch_refit.py) and
    # raises on InferenceData, as pyloo_tpu does; subsampling (Queue 1 item
    # 4) came with loo_subsample and scores each raw model on its subsample,
    # as pyloo_tpu does (numpy's global stream seeded alike for both)
    for pkg, models in ((jpl, JAX_MODELS), (tpl, TORCH_MODELS)):
        with pytest.raises(TypeError, match="Encountered error trying to compute kfold"):
            pkg.loo_compare(models, ic="kfold")
    np.random.seed(5)
    table, _ = _quiet(tpl.loo_compare, TORCH_MODELS, observations=10)
    np.random.seed(5)
    frame, _ = _quiet(jpl.loo_compare, JAX_MODELS, observations=10)
    assert table.index == list(frame.index)
    assert_allclose(table["elpd_loo"], frame["elpd_loo"].to_numpy(), **F64)
    assert_allclose(table["se"], frame["se"].to_numpy(), **F64)


def _series(seed, n=200):
    rng = np.random.default_rng(seed)
    ll = rng.normal(-1.0, 0.4, size=(2, 250, n))
    return {"posterior": {"mu": (rng.normal(size=(2, 250)), ("chain", "draw"), {})},
            "log_likelihood": {"y": (ll, ("chain", "draw", "time"), {})}}


def _elpd_of_both(groups, jfn, tfn, **kw):
    jid, tid = both(groups)
    return _quiet(jfn, jid, **kw)[0], _quiet(tfn, tid, **kw)[0]


def test_lfo_entries_rank_with_nan_p_column():
    pairs = [_elpd_of_both(_series(s), jpl.loo_lfo, tpl.loo_lfo, L=150, pointwise=True)
             for s in (4, 5)]
    jdict = {"a": pairs[0][0], "b": pairs[1][0]}
    tdict = {"a": pairs[0][1], "b": pairs[1][1]}
    tres, jres = _both_compare(jdict, tdict)  # ic="loo" warns: the entries' ic is lfo
    assert "elpd_lfo" in tres and np.isnan(tres["p_lfo"]).all()
    assert_same_table(tres, jres, F64)


def test_logo_entries():
    groups = np.arange(40) // 4
    jdict, tdict = {}, {}
    for name in ("m0", "m1"):
        jdict[name] = _quiet(jpl.loo_group, JAX_MODELS[name], groups, pointwise=True)[0]
        tdict[name] = _quiet(tpl.loo_group, TORCH_MODELS[name], groups, pointwise=True)[0]
    tres, jres = _both_compare(jdict, tdict, method="pseudo-bma")
    assert_same_table(tres, jres, F64)


def test_raw_entries_need_a_computable_ic():
    pairs = _elpd_of_both(_series(4), jpl.loo_lfo, tpl.loo_lfo, L=150, pointwise=True)
    with pytest.raises(ValueError, match="cannot be computed from raw data"):
        tpl.loo_compare({"a": pairs[1], "b": TORCH_MODELS["m0"]})


# --------------------------------------------------------------------------
# the stacking solvers
# --------------------------------------------------------------------------


def _pointwise_pair(seed, n=300, a=0.4, b=0.3):
    """Two models, each better on its own half: an interior optimum."""
    rng = np.random.default_rng(seed)
    x = rng.normal(-1.0, 0.3, size=(n, 2))
    x[: n // 2, 0] += a
    x[n // 2 :, 1] += b
    return x


# The turn count is equal where delta crosses tol by more than its roundoff.
# delta ~ 1e-14 is a difference of weights rounded to ~1e-16, so on slowly
# converging data the two libraries' float64 sums can stop one turn apart
# (seed 0 of the first kind: 429 turns here, 430 in pyloo_tpu; the weights
# then differ by ~1e-15).
@pytest.mark.parametrize("seed,a,b", [(1, 0.4, 0.3), (2, 0.4, 0.3), (3, 0.4, 0.3),
                                      (0, 2.0, 1.5)])
def test_em_solver_weights_and_iterations(seed, a, b):
    x = _pointwise_pair(seed, a=a, b=b)
    got = tstacking.stacking_weights_em(x)
    want = np.asarray(jstacking.stacking_weights_em(x))
    assert got.dtype == torch.float64
    assert_allclose(got.numpy(), want, **F64)
    shifted = x - x.max(axis=1, keepdims=True)
    t_w, t_iters = tstacking._em_solve(torch.exp(torch.from_numpy(shifted)), 5000, 1e-14)
    j_w, j_iters = jstacking._em_solve(jnp.exp(jnp.asarray(shifted)), 5000, 1e-14)
    assert t_iters == int(j_iters) < 5000  # stopped by the tolerance, not the cap
    assert t_iters % tstacking.BLOCK != 0  # the freeze matters: not a block boundary
    assert_allclose(t_w.numpy(), np.asarray(j_w), **F64)


def test_em_solver_stops_at_the_cap():
    x = _pointwise_pair(0)
    shifted = x - x.max(axis=1, keepdims=True)
    for cap in (1, 70, 130):
        _, t_iters = tstacking._em_solve(torch.exp(torch.from_numpy(shifted)), cap, 1e-14)
        _, j_iters = jstacking._em_solve(jnp.exp(jnp.asarray(shifted)), cap, 1e-14)
        assert t_iters == int(j_iters) == cap


@pytest.mark.parametrize("scale", ["log", "deviance"])
def test_device_solver_through_stacking_weights(scale):
    jdict, tdict = _precomputed("loo", scale)
    want = jcompare._stacking_weights(jdict, "loo", scale, solver="device")
    got = tcompare._stacking_weights(tdict, "loo", scale, solver="device")
    assert list(got) == list(want)
    assert_allclose([got[n] for n in got], [float(want[n]) for n in want], **F64)


def test_slsqp_weights_against_pyloo_tpu_on_raw_models():
    jdict = {n: _quiet(jpl.loo, m, pointwise=True)[0] for n, m in JAX_MODELS.items()}
    tdict = {n: _quiet(tpl.loo, m, pointwise=True)[0] for n, m in TORCH_MODELS.items()}
    want = jcompare._stacking_weights(jdict, "loo", "log")
    got = tcompare._stacking_weights(tdict, "loo", "log")
    # measured: 0 on this data; the pointwise inputs differ by ~1e-14
    assert_allclose([got[n] for n in got], [want[n] for n in want], rtol=0, atol=1e-10)


# --------------------------------------------------------------------------
# loo_model_weights, the callable module, the containers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["stacking", "bb-pseudo-bma", "pseudo-bma"])
def test_loo_model_weights(method):
    want, jmsg = _quiet(jpl.loo_model_weights, JAX_MODELS, method=method, seed=2)
    got, tmsg = _quiet(tpl.loo_model_weights, TORCH_MODELS, method=method, seed=2)
    assert tmsg == jmsg
    assert got.index == list(want.index) == ["m0", "m1", "m2"]  # insertion order
    assert_allclose(got.values, want.to_numpy(), **F64)
    assert_allclose(got["m1"], want["m1"], **F64)
    pd.testing.assert_series_equal(got.to_pandas(), want, check_exact=False, rtol=1e-12,
                                   atol=1e-12)
    assert abs(got.values.sum() - 1.0) < 1e-12
    assert [name for name, _ in got.items()] == got.index and "m2" in str(got)


def test_compare_module_is_callable():
    import importlib

    module = importlib.import_module("pyloo_tpu_torch.compare")
    assert tpl.compare is module and module.loo_compare is tpl.loo_compare
    jdict, tdict = _precomputed("loo", "log")
    direct = tpl.loo_compare(tdict)
    called = tpl.compare(tdict)
    assert called.index == direct.index
    for column in direct.columns:
        assert called[column].tolist() == direct[column].tolist()


def test_table_container():
    _, tdict = _precomputed("loo", "log")
    table = tpl.loo_compare(tdict)
    assert len(table) == 3 and "weight" in table and table.columns[0] == "rank"
    assert table["rank"][0] == 0 and table["elpd_diff"][0] == 0.0
    assert table["scale"].tolist() == ["log"] * 3
    text = str(table)
    assert all(name in text for name in table.index) and "elpd_loo" in text
    assert len(text.splitlines()) == 4
