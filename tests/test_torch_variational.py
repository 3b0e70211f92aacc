"""``pyloo_tpu_torch``'s ADVI and Laplace fits against ``pyloo_tpu``'s on the CPU.

ADVI, mean-field and full-rank, 200 Adam steps fed the noise ``jax.random``
makes for the same seed: the variational parameters and the ELBO trace
within 1e-9, ``compute_log_p`` / ``compute_log_q`` / ``compute_log_weights``
within 1e-12 on the same draws, and ``loo_approximate_posterior`` over the
fit within 1e-10 of ``pyloo_tpu``'s.  Laplace: the MAP and the covariance
within 1e-8 (scipy's BFGS on each package's log density and gradient, which
agree to rounding; the bar leaves room for BFGS's iterates to part at that
rounding, as they do on the wells model, where ``pyloo_tpu``'s run stops on
a precision-loss warning and the port's does not, 5e-9 apart), the same
draws for the same seed, ``compute_logq`` within 1e-12 on the same fit,
``_regularize_matrix`` equal, and ``loo_approximate_posterior`` within
1e-10.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu.models import advi as jadvi
from pyloo_tpu.models import examples as jex
from pyloo_tpu.models import laplace as jlap
from pyloo_tpu.models import wrapper as jwrap
from pyloo_tpu_torch.models import advi as tadvi
from pyloo_tpu_torch.models import examples as tex
from pyloo_tpu_torch.models import laplace as tlap
from pyloo_tpu_torch.models import wrapper as twrap

from .torch_parity import F64

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


def linreg_models(n=500):
    """``tests/test_variational.py``'s linear regression in both packages."""
    rng = np.random.default_rng(42)
    X = rng.normal(size=n)
    y = 0.5 + 1.5 * X + rng.normal(0, 0.8, size=n)

    def jll(p, d):
        mu = p["alpha"] + p["beta"] * d["X"]
        return (-0.5 * jnp.log(2 * jnp.pi) - p["log_s"]
                - 0.5 * ((d["y"] - mu) / jnp.exp(p["log_s"])) ** 2)

    def tll(p, d):
        mu = p["alpha"] + p["beta"] * d["X"]
        return (-0.5 * math.log(2 * math.pi) - p["log_s"]
                - 0.5 * ((d["y"] - mu) / torch.exp(p["log_s"])) ** 2)

    def prior(p):
        return (-0.5 * (p["alpha"] / 2) ** 2 - 0.5 * (p["beta"] / 2) ** 2
                - 0.5 * (p["log_s"] / 2) ** 2)

    shapes = {"alpha": (), "beta": (), "log_s": ()}
    return (
        jwrap.Model("linreg", {"X": X, "y": y}, shapes,
                    lambda p, d: prior(p) + jnp.sum(jll(p, d)), jll, obs_keys=("X", "y")),
        twrap.Model("linreg", {"X": X, "y": y}, shapes,
                    lambda p, d: prior(p) + torch.sum(tll(p, d)), tll, obs_keys=("X", "y")),
    )


MODELS = {
    "linreg": linreg_models,
    "eight_schools_noncentered": lambda: (
        jex.eight_schools_noncentered(), tex.eight_schools_noncentered()),
    "roaches": lambda: (jex.roaches_model(), tex.roaches_model()),
}


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def _same_idata(got, want, tol):
    for group in ("posterior", "sample_stats", "log_likelihood", "observed_data"):
        assert hasattr(got, group) == hasattr(want, group), group
        if not hasattr(want, group):
            continue
        g, w = getattr(got, group), getattr(want, group)
        assert list(g.data_vars) == list(w.data_vars), group
        for name in w.data_vars:
            assert g[name].dims == w[name].dims
            assert_allclose(g[name].values, w[name].values, **tol)


def _same_approx_loo(tid, jid, t_lw, j_lw):
    """``loo_approximate_posterior`` of both packages, log p - log q given."""
    kw = dict(pointwise=True, reff=1.0, seed=0)
    want = _quiet(jpl.loo_approximate_posterior, jid, log_p=j_lw, log_q=np.zeros_like(j_lw), **kw)
    got = _quiet(tpl.loo_approximate_posterior, tid, log_p=t_lw, log_q=np.zeros_like(t_lw), **kw)
    tol = dict(rtol=1e-10, atol=1e-10)
    for key in ("elpd_loo", "se", "p_loo", "looic"):
        assert_allclose(got[key], want[key], **tol)
    assert_allclose(got.loo_i.values, want.loo_i.values, **tol)
    assert_allclose(got.pareto_k.values, want.pareto_k.values, **tol)
    assert str(got) == str(want)


@pytest.mark.parametrize("method", ["meanfield", "fullrank"])
def test_advi_with_jax_noise_matches_pyloo_tpu(method):
    jm, tm = MODELS["eight_schools_noncentered"]()
    n, mc, draws, chains, seed, D = 200, 8, 100, 2, 3, jm.flat_dim
    ja = jadvi.ADVI(jm, method)
    want = _quiet(ja.fit, n=n, mc_samples=mc, seed=seed, draws=draws, chains=chains)
    # pyloo_tpu's noise (advi.py:134-150): a split of the key per step, one more for the draws
    key, noise = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (mc, D))))
    key, sub = jax.random.split(key)
    final = np.asarray(jax.random.normal(sub, (draws * chains, D)))
    ta = tadvi.ADVI(tm, method)
    got = ta._fit(lambda i: torch.from_numpy(noise[i]), lambda: torch.from_numpy(final), n, 1e-2,
                  draws, chains, True, torch.device("cpu"))

    tol = dict(rtol=1e-9, atol=1e-9)
    assert got.method == want.method and got.warnings == want.warnings
    assert_allclose(got.mean, want.mean, **tol)
    assert_allclose(got.elbo_trace, want.elbo_trace, **tol)
    if method == "fullrank":
        assert got.log_sigma is None and got.L.shape == (D, D)
        assert_allclose(got.L, want.L, **tol)
    else:
        assert got.L is None
        assert_allclose(got.log_sigma, want.log_sigma, **tol)
    _same_idata(got.idata, want.idata, F64)
    assert_allclose(ta.compute_log_p(), ja.compute_log_p(), **F64)
    assert_allclose(ta.compute_log_q(), ja.compute_log_q(), **F64)
    for scale in (False, True):
        assert_allclose(tadvi.compute_log_weights(ta, scale=scale),
                        jadvi.compute_log_weights(ja, scale=scale), **F64)
    _same_approx_loo(got.idata, want.idata, tadvi.compute_log_weights(ta),
                     jadvi.compute_log_weights(ja))


@pytest.mark.parametrize("name", ["eight_schools_noncentered", "roaches"])
def test_laplace_matches_pyloo_tpu(name):
    jm, tm = MODELS[name]()
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jl = jlap.Laplace(jm)
        want = jl.fit(draws=100, chains=2, seed=1)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tl = tlap.Laplace(tm)
        got = tl.fit(draws=100, chains=2, seed=1)
    # the fits' own warnings (torch's first use of its transforms may add
    # deprecation notices of its own)
    assert ([str(w.message) for w in tw if w.category is UserWarning]
            == [str(w.message) for w in jw if w.category is UserWarning])
    assert got.warnings == want.warnings
    tol = dict(rtol=1e-8, atol=1e-8)
    assert_allclose(got.mu, want.mu, **tol)
    assert_allclose(got.H_inv, want.H_inv, **tol)
    assert (got.H_inv == got.H_inv.T).all()
    _same_idata(got.idata, want.idata, tol)  # the same draws for the same seed
    assert_allclose(tl.compute_logp(), jl.compute_logp(), rtol=1e-10, atol=1e-8)
    if name != "roaches":  # log p agrees to 1e-8 on roaches (|log p| ~ 6,000)
        _same_approx_loo(got.idata, want.idata, tadvi.compute_log_weights(tl),
                         jadvi.compute_log_weights(jl))
    # log q on the same fit: the port's result given pyloo_tpu's mean,
    # covariance and draws, equal to 1e-12
    got.mu, got.H_inv = want.mu, want.H_inv
    got.idata = tl._assemble_idata(want.idata.sample_stats["_flat_draws"].values, True)
    assert_allclose(tl.compute_logq(), jl.compute_logq(), **F64)


def test_laplace_logq_takes_the_singular_retry_as_pyloo_tpu():
    jm, tm = MODELS["linreg"]()
    jl, tl = jlap.Laplace(jm), tlap.Laplace(tm)
    want = _quiet(jl.fit, draws=20, chains=1, seed=0)
    got = _quiet(tl.fit, draws=20, chains=1, seed=0)
    singular = np.diag([1.0, 1.0, 0.0])
    for res in (want, got):
        res.mu, res.H_inv = want.mu, singular
    got.idata = want.idata
    out = []
    for approx in (jl, tl):
        with pytest.warns(UserWarning, match="numerically singular"):
            out.append(approx.compute_logq())
    assert_allclose(out[1], out[0], rtol=0, atol=0)


def test_regularize_matrix_matches_pyloo_tpu():
    for matrix, lo, hi in ((np.eye(3), 1e-8, 1e2), (np.diag([1.0, -1e-6, 2.0]), 1e-8, 1e2),
                           (np.diag([1.0, -1e6, 1.0]), 1e-8, 1e-4)):
        results = []
        for mod in (jlap, tlap):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    out, msg = mod._regularize_matrix(matrix, lo, hi)
                except np.linalg.LinAlgError as err:
                    out, msg = None, f"LinAlgError: {err}"
            results.append((out, msg, [str(w.message) for w in caught]))
        (jout, jmsg, jw), (tout, tmsg, tw) = results
        assert tmsg == jmsg and tw == jw
        assert (tout is None and jout is None) or np.array_equal(tout, jout)


def test_fits_run_from_their_seed_and_refuse_what_pyloo_tpu_refuses():
    _, tm = MODELS["linreg"]()
    for method in ("meanfield", "fullrank"):
        advi = tadvi.ADVI(tm, method)
        res = advi.fit(n=300, draws=50, chains=2, seed=1)
        assert res.elbo_trace.shape == (300,) and np.isfinite(res.elbo_trace).all()
        assert np.mean(res.elbo_trace[-50:]) < np.mean(res.elbo_trace[:50])
        assert res.idata.log_likelihood["obs"].values.shape == (2, 50, 500)
        lw = tadvi.compute_log_weights(advi, scale=True)
        assert lw.shape == (100,) and abs(np.exp(lw).sum() - 1.0) < 1e-12
        again = tadvi.ADVI(tm, method).fit(n=300, draws=50, chains=2, seed=1)
        assert_allclose(again.mean, res.mean, rtol=0, atol=0)  # one generator, one seed
    with pytest.raises(ValueError, match="meanfield"):
        tadvi.ADVI(tm, "laplace")
    with pytest.raises(RuntimeError, match="fit"):
        tadvi.ADVI(tm).compute_log_p()
    with pytest.raises(RuntimeError, match="fit"):
        tlap.Laplace(tm).compute_logp()
    assert tpl.ADVI is tadvi.ADVI and tpl.Laplace is tlap.Laplace
    for name in ("ADVI", "ADVIResult", "Laplace", "LaplaceVIResult", "compute_log_weights",
                 "sample_nuts"):
        assert name in tpl.models.__all__


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tm = MODELS["linreg"]()
    tpl.rcParams["device.device"] = "cuda"
    try:
        for fit in (lambda: tadvi.ADVI(tm).fit(n=2), lambda: tlap.Laplace(tm).fit()):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fit()
    finally:
        tpl.rcParams["device.device"] = "cpu"
