"""``pyloo_tpu_torch``'s refit workflows against ``pyloo_tpu``'s on the CPU.

``loo_kfold``, ``reloo``, ``loo_compare(ic="kfold")`` and
``loo_lfo(wrapper=...)`` refit a model through its wrapper.  Both packages
get a wrapper whose ``sample_kwargs`` name a stand-in sampler: it returns
draws made with numpy from the refit's own data (a normal approximation of
its posterior), the same in both, so the two random number generators drop
out and the results agree within rtol/atol 1e-12, reports byte for byte.
The fold splitters give the same folds for the same seed.  The batched fold
refit (one HMC run of K x C chains) is held to the exact held-out
predictive densities of a conjugate model, as the serial folds are.
"""

import logging
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
from pyloo_tpu.models import wrapper as jwrap
from pyloo_tpu_torch.models import batched_refit
from pyloo_tpu_torch.models import wrapper as twrap

from .torch_parity import F64, assert_same_rows, assert_same_table

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)
    tpl.rcParams["device.device"] = old


def _series(seed=0, n=30, outliers=((0, 8.5), (1, -5.5))):
    y = np.random.default_rng(seed).normal(1.0, 1.0, size=n)
    for i, v in outliers:
        y[i] = v
    return y


def _jlogp(p, d):
    s = jnp.exp(p["log_s"])
    r = (d["y"] - p["mu"]) / s
    return (-0.5 * (p["mu"] / 10) ** 2 - 0.5 * (p["log_s"] / 2) ** 2
            + jnp.sum(-0.5 * jnp.log(2 * jnp.pi) - p["log_s"] - 0.5 * r**2))


def _jll(p, d):
    s = jnp.exp(p["log_s"])
    r = (d["y"] - p["mu"]) / s
    return -0.5 * jnp.log(2 * jnp.pi) - p["log_s"] - 0.5 * r**2


def _tlogp(p, d):
    s = torch.exp(p["log_s"])
    r = (d["y"] - p["mu"]) / s
    return (-0.5 * (p["mu"] / 10) ** 2 - 0.5 * (p["log_s"] / 2) ** 2
            + torch.sum(-0.5 * math.log(2 * math.pi) - p["log_s"] - 0.5 * r**2))


def _tll(p, d):
    s = torch.exp(p["log_s"])
    r = (d["y"] - p["mu"]) / s
    return -0.5 * math.log(2 * math.pi) - p["log_s"] - 0.5 * r**2


SHAPES = {"mu": (), "log_s": ()}


def _fixed_draws(y, chains=2, draws=150):
    """A normal approximation of the posterior of (mu, log_s) given ``y``,
    drawn with a numpy generator seeded from the data."""
    n = len(y)
    rng = np.random.default_rng(n * 7919 + int(round(abs(float(np.sum(y))) * 1e6)) % 100_003)
    mu = y.mean() + y.std() / math.sqrt(n) * rng.standard_normal((chains, draws))
    log_s = math.log(y.std()) + rng.standard_normal((chains, draws)) / math.sqrt(2 * n)
    return np.stack([mu, log_s], axis=-1)


def _sampler(idata_from_flat_draws):
    def sampler(model, **opts):
        return idata_from_flat_draws(model, _fixed_draws(np.asarray(model.data["y"])))

    return sampler


def _wrappers(y):
    jm = jwrap.Model("ls", {"y": y}, SHAPES, _jlogp, _jll, obs_keys=("y",))
    tm = twrap.Model("ls", {"y": y}, SHAPES, _tlogp, _tll, obs_keys=("y",))
    draws = _fixed_draws(y)
    jw = jpl.JAXModelWrapper(jm, jwrap.idata_from_flat_draws(jm, draws),
                             sample_kwargs={"sampler": _sampler(jwrap.idata_from_flat_draws)})
    tw = tpl.JAXModelWrapper(tm, twrap.idata_from_flat_draws(tm, draws),
                             sample_kwargs={"sampler": _sampler(twrap.idata_from_flat_draws)})
    return jw, tw


def _call(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, sorted(str(w.message) for w in caught)


@pytest.mark.parametrize("seed", [None, 0, 42])
@pytest.mark.parametrize("K", [2, 5, 7])
def test_fold_splitters_match_pyloo_tpu(K, seed):
    x = np.random.default_rng(3).normal(size=53)
    groups = np.random.default_rng(4).integers(0, 11, size=53)
    labels = np.random.default_rng(5).integers(0, 3, size=53)
    cases = [
        ("_kfold_split_random", dict(K=K, N=53)),
        ("_kfold_split_stratified", dict(K=K, x=x)),
        ("_kfold_split_stratified", dict(K=K, x=labels)),
        ("_kfold_split_grouped", dict(K=K, groups=groups)),
    ]
    for name, kw in cases:
        np.random.seed(11)  # seed=None draws from numpy's global stream
        want = getattr(jpl, name)(seed=seed, **kw)
        np.random.seed(11)
        got = getattr(tpl, name)(seed=seed, **kw)
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("kw", [
    dict(K=5, random_seed=1),
    dict(K=3, random_seed=2, scale="deviance"),
    dict(K=4, random_seed=3, stratify="y"),
    dict(K=3, random_seed=4, groups=True, pointwise=False),
    dict(folds=True),
], ids=["random", "deviance", "stratified", "grouped", "explicit_folds"])
def test_loo_kfold_matches_pyloo_tpu(kw):
    y = _series()
    jw, tw = _wrappers(y)
    kw = dict(kw)
    if kw.get("stratify") == "y":
        kw["stratify"] = y
    if kw.get("groups"):
        kw["groups"] = np.arange(len(y)) // 4
    if kw.get("folds"):
        kw["folds"] = np.arange(len(y)) % 6 + 1
    j, jmsg = _call(jpl.loo_kfold, jw, **kw)
    t, tmsg = _call(tpl.loo_kfold, tw, **kw)
    assert_same_rows(t, j)
    assert str(t) == str(j)
    assert tmsg == jmsg
    assert t.method == "kfold" and t.K == j.K


def test_loo_kfold_argument_errors_match_pyloo_tpu():
    jw, tw = _wrappers(_series())
    for pkg, w in ((jpl, jw), (tpl, tw)):
        with pytest.raises(TypeError, match="Expected JAXModelWrapper"):
            pkg.loo_kfold(object())
        with pytest.raises(ValueError, match="K must be positive"):
            pkg.loo_kfold(w, K=0)
        with pytest.raises(ValueError, match="Fold indices must be >= 1"):
            pkg.loo_kfold(w, folds=np.arange(30) % 3)


def test_reloo_matches_pyloo_tpu():
    jw, tw = _wrappers(_series())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jorig = jpl.loo(jw.idata, pointwise=True)
        torig = tpl.loo(tw.idata, pointwise=True)
    assert np.sum(torig.pareto_k.values > 0.7) >= 1
    j, _ = _call(jpl.reloo, jw, k_thresh=0.5)
    t, _ = _call(tpl.reloo, tw, k_thresh=0.5)
    assert_same_rows(t, j)
    assert str(t) == str(j)
    # the wrappers' data is restored after each refit
    assert tw.n_obs == 30
    # with loo_orig given, and nothing above the threshold
    j, _ = _call(jpl.reloo, jw, loo_orig=jorig, k_thresh=10.0)
    t, _ = _call(tpl.reloo, tw, loo_orig=torig, k_thresh=10.0)
    assert_same_rows(t, j)


def test_loo_compare_kfold_matches_pyloo_tpu():
    y = _series()
    (ja, ta), (jb, tb) = _wrappers(y), _wrappers(y[::-1].copy())
    kw = dict(ic="kfold", K=3, random_seed=6)
    frame, _ = _call(jpl.loo_compare, {"a": ja, "b": jb}, **kw)
    table, _ = _call(tpl.loo_compare, {"a": ta, "b": tb}, **kw)
    assert_same_table(table, frame, F64)


@pytest.mark.parametrize("M", [1, 3])
def test_loo_lfo_with_refits_matches_pyloo_tpu(M):
    # a level shift at t = 24 sends the PSIS ratios' k over the threshold
    y = np.concatenate([np.random.default_rng(7).normal(0.0, 1.0, 24),
                        np.random.default_rng(8).normal(4.0, 1.0, 16)])
    jw, tw = _wrappers(y)
    j, _ = _call(jpl.loo_lfo, L=15, M=M, wrapper=jw, pointwise=True)
    t, _ = _call(tpl.loo_lfo, L=15, M=M, wrapper=tw, pointwise=True)
    assert j["n_refits"] >= 1
    assert_same_rows(t, j)
    assert str(t) == str(j)
    assert tw.n_obs == 40  # the full series is restored


def _conjugate(n=24, seed=9):
    """y_i ~ N(mu, 1), mu ~ N(0, 10^2): the held-out predictive is exact."""
    y = np.random.default_rng(seed).normal(0.7, 1.0, size=n)

    def logp(p, d):
        return -0.5 * (p["mu"] / 10.0) ** 2 + torch.sum(-0.5 * (d["y"] - p["mu"]) ** 2)

    def log_lik(p, d):
        return -0.5 * math.log(2 * math.pi) - 0.5 * (d["y"] - p["mu"]) ** 2

    model = twrap.Model("conj", {"y": y}, {"mu": ()}, logp, log_lik, obs_keys=("y",))
    return y, model


def _exact_heldout(y, folds):
    out = np.empty(len(y))
    for k in np.unique(folds):
        train = y[folds != k]
        prec = len(train) + 1 / 100.0
        m, v = train.sum() / prec, 1.0 / prec
        val = folds == k
        out[val] = -0.5 * np.log(2 * np.pi * (1 + v)) - 0.5 * (y[val] - m) ** 2 / (1 + v)
    return out


def test_batched_folds_match_the_exact_predictive_as_serial_folds_do(monkeypatch):
    y, model = _conjugate()
    folds = np.arange(len(y)) % 3 + 1
    draws = np.random.default_rng(10).normal(0.7, 0.2, size=(2, 100, 1))
    wrapper = tpl.JAXModelWrapper(model, twrap.idata_from_flat_draws(model, draws))
    opts = dict(draws=150, tune=150, chains=2, num_leapfrog=4, seed=3)
    calls = []
    real = batched_refit.kfold_refit_batched
    # the package exports a function named as the module
    monkeypatch.setattr(sys.modules["pyloo_tpu_torch.loo_kfold"], "kfold_refit_batched",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    batched = tpl.loo_kfold(wrapper, folds=folds, pointwise=True, **opts)
    assert calls == [1]
    # an option of fit() that the batched run does not take: the serial folds
    serial = tpl.loo_kfold(wrapper, folds=folds, pointwise=True, init=np.zeros(1), **opts)
    assert calls == [1]
    exact = _exact_heldout(y, folds)
    for res in (batched, serial):
        err = res.kfold_i.values - exact
        # each held-out density is a mean over ~300 correlated draws of a
        # posterior with sd 0.2: a few hundredths of Monte Carlo error
        assert np.abs(err).max() < 0.1, np.abs(err).max()
        assert abs(err.sum()) < 0.3, err.sum()
    elpd, accept = real(model, np.stack([np.nonzero(folds != k)[0] for k in (1, 2, 3)]),
                        np.stack([np.nonzero(folds == k)[0] for k in (1, 2, 3)]), **opts)
    assert elpd.shape == (3, 8) and accept.shape == (3,) and (accept > 0.5).all()


def test_a_failure_inside_the_batched_run_raises():
    """``pyloo_tpu`` catches any exception of its batched program and refits
    fold by fold; the port raises it."""
    y, model = _conjugate(n=12)

    def logp(p, d):
        if float(p["mu"]) > 1e9:  # a host read: torch.func cannot transform it
            return p["mu"]
        return -0.5 * p["mu"] ** 2

    broken = twrap.Model("broken", {"y": y}, {"mu": ()}, logp, model.log_lik, obs_keys=("y",))
    draws = np.zeros((2, 10, 1))
    wrapper = tpl.JAXModelWrapper(broken, twrap.idata_from_flat_draws(broken, draws))
    with pytest.raises(RuntimeError):
        tpl.loo_kfold(wrapper, K=3, random_seed=0, draws=5, tune=5, chains=2, num_leapfrog=2)


def test_reloo_batched_path_refits_each_bad_observation():
    y, model = _conjugate(n=16)
    y = y.copy()
    y[3] = 6.0
    model = twrap.Model("conj", {"y": y}, {"mu": ()}, model.logp, model.log_lik,
                        obs_keys=("y",))
    idata = tpl.models.fit(model, draws=150, tune=150, chains=2, num_leapfrog=4, seed=1)
    wrapper = tpl.JAXModelWrapper(model, idata, sample_kwargs=dict(
        draws=150, tune=150, chains=2, num_leapfrog=4, seed=2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        orig = tpl.loo(idata, pointwise=True)
        res = tpl.reloo(wrapper, loo_orig=orig, k_thresh=0.25)
    bad = orig.pareto_k.values > 0.25
    assert bad.sum() >= 1
    assert (res.pareto_k.values[bad] == 0).all()
    folds = np.arange(16) + 1
    exact = _exact_heldout(y, folds)
    # Monte Carlo error of a mean over ~300 draws of a density ~5 sd out (~0.1)
    assert np.abs(res.loo_i.values[bad] - exact[bad]).max() < 0.4
    assert_allclose(res.loo_i.values[~bad], orig.loo_i.values[~bad], rtol=0, atol=0)
