"""``pyloo_tpu_torch.models.pymc_adapter`` against ``pyloo_tpu``'s on the CPU.

PyMC is not installed, so the bridge that PyTensor would compile is written
by hand: the same model (``mu ~ Normal(0, 5)``, ``sigma ~ HalfNormal(2)``
with its log transform, ``y ~ Normal(mu, sigma)``) in ``jax.numpy`` for
``pyloo_tpu`` and in torch for the port.  ``from_bridge``'s log density and
log-likelihood, ``unconstrain_posterior`` and ``ingest_pymc_idata`` agree
within rtol/atol 1e-12; ``PyMCWrapper`` over a stand-in PyMC model selects
observations as ``pyloo_tpu``'s does and feeds ``reloo``, ``loo_kfold`` and
``loo_moment_match`` as a native ``Model`` of the same functions does.
"""

import math
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu.models import pymc_adapter as jadapt
from pyloo_tpu_torch.models import pymc_adapter as tadapt
from pyloo_tpu_torch.models import wrapper as twrap

from .test_pymc_adapter import FakePyMCModel, make_bridge
from .torch_parity import F64, assert_same_rows

torch.set_num_threads(1)

N_OBS = 20


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


def _y(outlier=6.5):
    y = np.random.default_rng(11).normal(0.5, 1.0, size=N_OBS)
    y[0] = outlier
    return y


def _tll(params, y):
    s = torch.exp(params["sigma_log__"])
    return -0.5 * math.log(2 * math.pi) - torch.log(s) - 0.5 * ((y - params["mu"]) / s) ** 2


def _tprior(params):
    ls = params["sigma_log__"]
    return -0.5 * (params["mu"] / 5.0) ** 2 - 0.5 * (torch.exp(ls) / 2.0) ** 2 + ls


def torch_bridge(y, device="cpu"):
    """The bridge of ``tests/test_pymc_adapter.make_bridge`` in torch."""
    yt = torch.as_tensor(y, device=device)

    def log_lik(params):
        return _tll(params, yt)

    def logp(params):
        return _tprior(params) + torch.sum(log_lik(params))

    return tadapt.PyTensorJaxBridge(
        name="normal_model",
        param_shapes={"mu": (), "sigma_log__": ()},
        logp=logp,
        log_lik=log_lik,
        observed={"y": y},
        constrain=lambda p: {"mu": p["mu"], "sigma": torch.exp(p["sigma_log__"])},
        forward=lambda c: {"mu": c["mu"], "sigma_log__": torch.log(c["sigma"])},
        free_names=("mu", "sigma"),
    )


def native_model(y):
    """The same model as a native ``Model`` over its data."""
    return twrap.Model(
        "normal_model", {"y": y}, {"mu": (), "sigma_log__": ()},
        lambda p, d: _tprior(p) + torch.sum(_tll(p, d["y"])),
        lambda p, d: _tll(p, d["y"]),
        constrain=lambda p: {"mu": p["mu"], "sigma": torch.exp(p["sigma_log__"])},
        obs_keys=("y",),
    )


def _qs(n=6, seed=0):
    return np.random.default_rng(seed).normal(0.0, 0.7, size=(n, 2))


def test_from_bridge_logp_and_log_lik_match_pyloo_tpu():
    y = _y()
    jm, tm = jadapt.from_bridge(make_bridge(y)), tadapt.from_bridge(torch_bridge(y))
    assert tm.obs_keys == jm.obs_keys == ("__obs_idx__", "y")
    assert tm.n_obs == jm.n_obs == N_OBS
    keep = np.array([0, 3, 4, 9, 15, 19])
    jsub, tsub = jm.subset_observations(keep), tm.subset_observations(keep)
    for q in _qs():
        for j, t in ((jm, tm), (jsub, tsub)):
            tq = torch.tensor(q)
            assert_allclose(float(t.logp_flat(tq)), float(j.logp_flat(jnp.asarray(q))), **F64)
            assert_allclose(t.log_lik_flat(tq).numpy(),
                            np.asarray(j.log_lik_flat(jnp.asarray(q))), **F64)
        # the leave-out log joint: full = subset + the removed observations' log-lik
        tq = torch.tensor(q)
        removed = np.setdiff1d(np.arange(N_OBS), keep)
        assert_allclose(float(tm.logp_flat(tq)),
                        float(tsub.logp_flat(tq)) + float(tm.log_lik_flat(tq)[removed].sum()),
                        **F64)
    # the gradient of the leave-out log joint, through torch.func
    q = torch.tensor(_qs()[0])
    grad = torch.func.grad(tsub.logp_flat)(q)
    native = native_model(_y()[keep])
    assert_allclose(grad.numpy(), torch.func.grad(native.logp_flat)(q).numpy(), **F64)


def test_from_bridge_refuses_a_model_without_observations():
    empty = tadapt.PyTensorJaxBridge(name="empty", param_shapes={"a": ()},
                                     logp=lambda p: p["a"], log_lik=lambda p: p["a"][None],
                                     observed={})
    with pytest.raises(ValueError, match="no observed"):
        tadapt.from_bridge(empty)


def test_unconstrain_posterior_matches_pyloo_tpu():
    y = _y()
    rng = np.random.default_rng(0)
    post = {"mu": rng.normal(size=(3, 7)), "sigma": np.abs(rng.normal(size=(3, 7))) + 0.1}
    got = tadapt.unconstrain_posterior(torch_bridge(y), post)
    want = jadapt.unconstrain_posterior(make_bridge(y), post)
    assert got.shape == want.shape == (3, 7, 2)
    assert_allclose(got, want, **F64)
    nofwd = tadapt.PyTensorJaxBridge(name="nofwd", param_shapes={"a": ()},
                                     logp=lambda p: p["a"], log_lik=lambda p: p["a"][None],
                                     observed={"y": np.zeros(1)})
    with pytest.raises(ValueError, match="forward"):
        tadapt.unconstrain_posterior(nofwd, {"a": np.zeros((1, 2))})


def _foreign_posterior(pkg, seed=1):
    rng = np.random.default_rng(seed)
    mu = rng.normal(0.5, 0.2, size=(2, 60))
    sigma = np.abs(rng.normal(1.2, 0.1, size=(2, 60)))
    return pkg.InferenceData(posterior=pkg.Dataset({
        "mu": pkg.DataArray(mu, ("chain", "draw"), name="mu"),
        "sigma": pkg.DataArray(sigma, ("chain", "draw"), name="sigma"),
    }))


def test_ingest_pymc_idata_matches_pyloo_tpu():
    y = _y()
    jb, tb = make_bridge(y), torch_bridge(y)
    j = jadapt.ingest_pymc_idata(jb, jadapt.from_bridge(jb), _foreign_posterior(jpl))
    t = tadapt.ingest_pymc_idata(tb, tadapt.from_bridge(tb), _foreign_posterior(tpl))
    assert t.groups() == j.groups()
    for group in j.groups():
        for name, jv in getattr(j, group).items():
            tv = getattr(t, group)[name]
            assert tv.dims == jv.dims, (group, name)
            assert_allclose(tv.values, np.asarray(jv.values), **F64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert_same_rows(tpl.loo(t, pointwise=True), jpl.loo(j, pointwise=True))
    # a foreign (arviz-style) container goes through convert_foreign
    from .test_ingest import _FakeDataset, _FakeIdata, _FakeVar

    ds = _foreign_posterior(jpl).posterior
    fake = _FakeIdata(posterior=_FakeDataset(
        {k: _FakeVar(v.values, v.dims) for k, v in ds.items()}))
    via_foreign = tadapt.ingest_pymc_idata(tb, tadapt.from_bridge(tb), fake)
    assert_allclose(via_foreign.log_likelihood["obs"].values, t.log_likelihood["obs"].values,
                    rtol=0, atol=0)
    lacking = tpl.InferenceData(posterior=tpl.Dataset(
        {"mu": tpl.DataArray(np.zeros((1, 4)), ("chain", "draw"), name="mu")}))
    with pytest.raises(ValueError, match="sigma"):
        tadapt.ingest_pymc_idata(tb, tadapt.from_bridge(tb), lacking)


def test_is_pymc_model_on_a_stand_in():
    for mod in (jadapt, tadapt):
        assert mod.is_pymc_model(FakePyMCModel())
        assert not mod.is_pymc_model(object())
        assert not mod.is_pymc_model({"basic_RVs": 1})


@pytest.fixture()
def wrappers(monkeypatch):
    """PyMCWrapper over a stand-in PyMC model in both packages, each adapter
    handing back its hand-written bridge, with the same foreign idata."""
    y = _y()
    monkeypatch.setattr(jadapt, "_build_bridge_from_pymc", lambda m: make_bridge(y))
    monkeypatch.setattr(tadapt, "_build_bridge_from_pymc", lambda m: torch_bridge(y))
    jw = jpl.PyMCWrapper(FakePyMCModel(), _foreign_posterior(jpl))
    tw = tpl.PyMCWrapper(FakePyMCModel(), _foreign_posterior(tpl))
    return jw, tw


def test_pymc_wrapper_selects_observations_as_pyloo_tpu(wrappers):
    jw, tw = wrappers
    assert tw.bridge is not None and tw.n_obs == jw.n_obs == N_OBS
    assert tw.get_variable_names() == jw.get_variable_names()
    assert tw.get_shapes() == jw.get_shapes()
    assert tw.get_observed_name() == jw.get_observed_name() == "y"
    for sel in ([2, 5, 7], slice(3, 9), np.arange(N_OBS) % 4 == 0):
        (jsel, jrem), (tsel, trem) = jw.select_observations(sel), tw.select_observations(sel)
        for a, b in ((tsel, jsel), (trem, jrem)):
            assert list(a) == list(b)
            for key in b:
                np.testing.assert_array_equal(a[key], np.asarray(b[key]))
    with pytest.raises(IndexError):
        tw.select_observations([N_OBS])
    ll = tw.log_likelihood_i(np.array([0, 4]), tw.idata)
    want = jw.log_likelihood_i(np.array([0, 4]), jw.idata)
    assert_allclose(ll, np.asarray(want), **F64)
    assert_allclose(tw.get_unconstrained_parameters(), jw.get_unconstrained_parameters(), **F64)
    # a native Model passes through as it does in pyloo_tpu
    native = tpl.PyMCWrapper(native_model(_y()))
    assert native.bridge is None and native.n_obs == N_OBS


def _fixed_sampler(model, **opts):
    """Draws made with numpy from the refit's own data: the same in each
    wrapper, so the refits differ only by the model's arithmetic."""
    y = np.asarray(model.data["y"])
    rng = np.random.default_rng(len(y) * 31 + int(abs(y.sum()) * 1e6) % 10_007)
    mu = y.mean() + y.std() / math.sqrt(len(y)) * rng.standard_normal((2, 120))
    ls = math.log(y.std()) + rng.standard_normal((2, 120)) / math.sqrt(2 * len(y))
    return twrap.idata_from_flat_draws(model, np.stack([mu, ls], axis=-1))


def _pair(sample_kwargs):
    y = _y()
    bridge_model = tadapt.from_bridge(torch_bridge(y))
    native = native_model(y)
    idata = _fixed_sampler(native)
    return (tpl.PyMCWrapper(bridge_model, _fixed_sampler(bridge_model), sample_kwargs=sample_kwargs),
            tpl.JAXModelWrapper(native, idata, sample_kwargs=sample_kwargs))


def test_reloo_through_the_bridge_equals_the_native_model():
    """One small reloo, its refits one batched HMC run of 2 chains x
    (30 + 30) at 4 leapfrog steps, in each wrapper."""
    bw, nw = _pair(dict(draws=30, tune=30, chains=2, num_leapfrog=4, seed=3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        borig = tpl.loo(bw.idata, pointwise=True)
        norig = tpl.loo(nw.idata, pointwise=True)
        assert_same_rows(borig, norig)
        assert (norig.pareto_k.values > 0.5).sum() >= 1
        b = tpl.reloo(bw, loo_orig=borig, k_thresh=0.5)
        n = tpl.reloo(nw, loo_orig=norig, k_thresh=0.5)
    assert_same_rows(b, n, dict(rtol=1e-9, atol=1e-9))
    assert bw.n_obs == N_OBS


def test_loo_kfold_and_moment_match_through_the_bridge_equal_the_native_model():
    bw, nw = _pair({"sampler": _fixed_sampler})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        b = tpl.loo_kfold(bw, K=4, random_seed=0, pointwise=True)
        n = tpl.loo_kfold(nw, K=4, random_seed=0, pointwise=True)
        assert_same_rows(b, n)
        orig = tpl.loo(nw.idata, pointwise=True)
        mb = tpl.loo_moment_match(bw, orig, k_threshold=0.3, split=False)
        mn = tpl.loo_moment_match(nw, orig, k_threshold=0.3, split=False)
    assert_same_rows(mb, mn, dict(rtol=1e-10, atol=1e-10))


def test_fit_of_the_bridge_model_equals_the_native_model():
    y = _y()
    kw = dict(draws=20, tune=20, chains=2, num_leapfrog=3, seed=5)
    b = tpl.models.fit(tadapt.from_bridge(torch_bridge(y)), **kw)
    n = tpl.models.fit(native_model(y), **kw)
    assert_allclose(b.sample_stats["_flat_draws"].values, n.sample_stats["_flat_draws"].values,
                    rtol=1e-9, atol=1e-9)
    assert_allclose(b.log_likelihood["obs"].values, n.log_likelihood["obs"].values,
                    rtol=1e-9, atol=1e-9)


def test_drop_in_import_paths():
    from pyloo_tpu_torch.wrapper import Laplace, PyMCWrapper
    from pyloo_tpu_torch.wrapper.pymc import PyMCWrapper as P2
    from pyloo_tpu_torch.wrapper.pymc import PyTensorJaxBridge, from_pymc

    assert PyMCWrapper is P2 is tpl.PyMCWrapper is tadapt.PyMCWrapper
    assert Laplace is tpl.Laplace
    assert PyTensorJaxBridge is tadapt.PyTensorJaxBridge and from_pymc is tadapt.from_pymc
    import pyloo_tpu.wrapper.pymc as jmod
    import pyloo_tpu_torch.wrapper.pymc as tmod

    assert tmod.__all__ == jmod.__all__


def test_from_pymc_raises_import_error_without_pymc(monkeypatch):
    monkeypatch.setitem(sys.modules, "pymc", None)
    with pytest.raises(ImportError, match="requires pymc"):
        tadapt.from_pymc(FakePyMCModel())
    with pytest.raises(ImportError, match="requires pymc"):
        tpl.PyMCWrapper(FakePyMCModel())
