"""``pyloo_tpu_torch.models`` against ``pyloo_tpu.models`` on the CPU.

Each model is written twice, in ``jnp`` (``pyloo_tpu``'s example models and
the outlier model of ``tests/test_moment_match.py``) and in torch, over the
same numpy data.  ``ravel`` / ``unravel`` / ``logp_flat`` / ``log_lik_flat``
and the gradient agree within rtol/atol 1e-12; one leapfrog trajectory
within 1e-12; a short HMC run fed the draws ``jax.random`` makes for the
same seed within 1e-9 of ``pyloo_tpu``'s ``sample_hmc``; and a longer run on
a conjugate normal model finds its posterior mean and sd within 4 MCSE.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu.models import examples as jex
from pyloo_tpu.models import hmc as jhmc
from pyloo_tpu.models import wrapper as jwrap
from pyloo_tpu_torch.models import examples as tex
from pyloo_tpu_torch.models import hmc as thmc
from pyloo_tpu_torch.models import wrapper as twrap
from pyloo_tpu_torch.ops.ess import ess_mean

from .torch_parity import F64

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


def outlier_models(seed=0, outlier=8.5, n=30):
    """The outlier model of ``tests/test_moment_match.py:24-46`` in both packages."""
    rng = np.random.default_rng(seed)
    y = rng.normal(1.0, 1.0, size=n)
    y[0] = outlier

    def jlogp(p, d):
        s = jnp.exp(p["log_s"])
        r = (d["y"] - p["mu"]) / s
        return (
            -0.5 * (p["mu"] / 10) ** 2
            - 0.5 * (p["log_s"] / 2) ** 2
            + jnp.sum(-0.5 * jnp.log(2 * jnp.pi) - p["log_s"] - 0.5 * r**2)
        )

    def jll(p, d):
        s = jnp.exp(p["log_s"])
        r = (d["y"] - p["mu"]) / s
        return -0.5 * jnp.log(2 * jnp.pi) - p["log_s"] - 0.5 * r**2

    def tlogp(p, d):
        s = torch.exp(p["log_s"])
        r = (d["y"] - p["mu"]) / s
        return (
            -0.5 * (p["mu"] / 10) ** 2
            - 0.5 * (p["log_s"] / 2) ** 2
            + torch.sum(-0.5 * math.log(2 * math.pi) - p["log_s"] - 0.5 * r**2)
        )

    def tll(p, d):
        s = torch.exp(p["log_s"])
        r = (d["y"] - p["mu"]) / s
        return -0.5 * math.log(2 * math.pi) - p["log_s"] - 0.5 * r**2

    shapes = {"mu": (), "log_s": ()}
    return (
        jwrap.Model("ls", {"y": y}, shapes, jlogp, jll, obs_keys=("y",)),
        twrap.Model("ls", {"y": y}, shapes, tlogp, tll, obs_keys=("y",)),
    )


MODELS = {
    "eight_schools_centered": lambda: (jex.eight_schools_centered(), tex.eight_schools_centered()),
    "eight_schools_noncentered": lambda: (
        jex.eight_schools_noncentered(), tex.eight_schools_noncentered()),
    "roaches": lambda: (jex.roaches_model(), tex.roaches_model()),
    "wells": lambda: (jex.wells_model(), tex.wells_model()),
    "outlier": outlier_models,
}


def _draws(model, n=4, seed=0, scale=0.7):
    return np.random.default_rng(seed).normal(0.0, scale, size=(n, model.flat_dim))


@pytest.mark.parametrize("name", list(MODELS))
def test_model_functions_match_pyloo_tpu(name):
    jm, tm = MODELS[name]()
    assert tm.flat_dim == jm.flat_dim and tm.n_obs == jm.n_obs
    for k in jm.data:
        assert_allclose(np.asarray(tm.data[k]), np.asarray(jm.data[k]), rtol=0, atol=0)
    for q in _draws(jm):
        qt = torch.from_numpy(q.copy())
        ju, tu = jm.unravel(jnp.asarray(q)), tm.unravel(qt)
        assert list(tu) == list(ju)
        for k in ju:
            assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=0, atol=0)
        assert_allclose(tm.ravel(tu).numpy(), np.asarray(jm.ravel(ju)), rtol=0, atol=0)
        assert_allclose(float(tm.logp_flat(qt)), float(jm.logp_flat(jnp.asarray(q))), **F64)
        assert_allclose(tm.log_lik_flat(qt).numpy(), np.asarray(jm.log_lik_flat(jnp.asarray(q))),
                        **F64)
        gt = torch.func.grad(tm.logp_flat)(qt).numpy()
        gj = np.asarray(jax.grad(jm.logp_flat)(jnp.asarray(q)))
        assert_allclose(gt, gj, **F64)
        if tm.constrain is not None:
            jc, tc = jm.constrain(ju), tm.constrain(tu)
            for k in jc:
                assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **F64)


@pytest.mark.parametrize("name", ["eight_schools_centered", "roaches"])
def test_subsetting_matches_pyloo_tpu(name):
    jm, tm = MODELS[name]()
    keep = np.arange(0, jm.n_obs, 2)
    js, ts = jm.subset_observations(keep), tm.subset_observations(keep)
    assert ts.flat_dim == js.flat_dim and ts.n_obs == js.n_obs
    q = _draws(js, n=1)[0]
    assert_allclose(float(ts.logp_flat(torch.from_numpy(q))), float(js.logp_flat(jnp.asarray(q))),
                    **F64)


@pytest.mark.parametrize("name", ["roaches", "wells"])
def test_example_tables_match_pyloo_tpu(name):
    frame = jpl.load_example_data(name)
    columns = tpl.load_example_data(name)
    assert list(columns) == list(frame.columns)
    for col in frame.columns:
        assert columns[col].dtype == np.float64
        assert_allclose(columns[col], frame[col].to_numpy(dtype=np.float64), rtol=0, atol=0)


def _value_and_grad(tm):
    data = tm.tensor_data("cpu")
    return thmc._value_and_grad(lambda q: -tm.logp(tm.unravel(q), data))


@pytest.mark.parametrize("name", ["eight_schools_noncentered", "roaches"])
def test_leapfrog_matches_pyloo_tpu(name):
    jm, tm = MODELS[name]()
    C, D, n_steps, eps = 3, jm.flat_dim, 7, 0.05
    q, p = _draws(jm, n=C, seed=1, scale=0.3), _draws(jm, n=C, seed=2, scale=1.0)
    inv_mass = np.random.default_rng(3).uniform(0.5, 1.5, size=(C, D))
    grad_fn = jax.grad(lambda q: -jm.logp_flat(q))
    qj, pj = jax.vmap(lambda q, p, m: jhmc._leapfrog(grad_fn, q, p, eps, m, n_steps))(q, p, inv_mass)
    vg = _value_and_grad(tm)
    qt = torch.from_numpy(q.copy())
    v0, g0 = vg(qt)
    qt, pt, vt, gt = thmc._leapfrog(vg, qt, torch.from_numpy(p.copy()), v0, g0, eps,
                                    torch.from_numpy(inv_mass), n_steps)
    assert_allclose(qt.numpy(), np.asarray(qj), **F64)
    assert_allclose(pt.numpy(), np.asarray(pj), **F64)
    # the end point's potential and gradient come with it
    assert_allclose(vt.numpy(), -np.asarray(jax.vmap(jm.logp_flat)(qj)), **F64)
    assert_allclose(gt.numpy(), np.asarray(jax.vmap(grad_fn)(qj)), **F64)


def _jax_run_draws(seed, C, D, total):
    """``pyloo_tpu.models.hmc.sample_hmc``'s random draws for ``seed``
    (``hmc.py:135-143``, ``:83-95``): the jittered start and, per step and
    chain, the momenta, the jitter uniform and the accept uniform."""
    key = jax.random.PRNGKey(seed)
    k_init, key = jax.random.split(key)
    init_q = np.asarray(jax.random.normal(k_init, (C, D)) * 0.5)

    def per_chain(chain_key):
        def per_step(step_key):
            k_mom, k_jit, k_acc = jax.random.split(step_key, 3)
            return (jax.random.normal(k_mom, (D,)), jax.random.uniform(k_jit),
                    jax.random.uniform(k_acc))

        return jax.vmap(per_step)(jax.random.split(chain_key, total))

    z, u_jit, u_acc = (np.asarray(a) for a in jax.vmap(per_chain)(jax.random.split(key, C)))

    def draws(t):
        return (torch.from_numpy(z[:, t].copy()), torch.from_numpy(u_jit[:, t].copy()),
                torch.from_numpy(u_acc[:, t].copy()))

    return init_q, draws


# 4 leapfrog steps: at 32, the adapted step size makes the trajectories
# chaotic, and a 1-ulp change of the start (the two libraries' exp and their
# constant folding differ in the last bit) grows to ~1e-3 within 40 steps in
# either package against itself
@pytest.mark.parametrize("name", ["eight_schools_noncentered", "eight_schools_centered"])
def test_hmc_run_with_jax_draws_matches_sample_hmc(name):
    jm, tm = MODELS[name]()
    C, W, N, L, seed = 2, 20, 20, 4, 3
    D = jm.flat_dim
    want, want_acc = jhmc.sample_hmc(jm.logp_flat, np.zeros(D), num_warmup=W, num_samples=N,
                                     num_chains=C, num_leapfrog=L, seed=seed)
    init_q, draws = _jax_run_draws(seed, C, D, W + N)
    got, acc = thmc._run_chains(_value_and_grad(tm), torch.from_numpy(init_q), draws, W, N, L,
                                0.8)
    assert got.shape == (C, N, D)
    assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    assert_allclose(float(acc.mean()), want_acc, rtol=1e-9, atol=1e-9)


def test_sample_hmc_finds_a_conjugate_posterior():
    """y_i ~ N(mu, 1), mu ~ N(0, 10^2); log_s ~ N(0.5, 0.3^2) independent of
    the data: the posterior is normal in both coordinates, known exactly.

    The acceptance is held to ``pyloo_tpu``'s on the same model, not to the
    0.8 that dual averaging targets: both samplers adopt the mass matrix at
    85% of warmup and keep averaging the step size over the whole warmup, so
    after warmup both accept about 0.98 of proposals here."""
    y = np.random.default_rng(5).normal(1.5, 1.0, size=25)
    prec = len(y) + 1 / 100.0
    mean = np.array([y.sum() / prec, 0.5])
    sd = np.array([prec**-0.5, 0.3])
    yt = torch.from_numpy(y)

    def logp(q):
        return (-0.5 * (q[0] / 10.0) ** 2 - 0.5 * torch.sum((yt - q[0]) ** 2)
                - 0.5 * ((q[1] - 0.5) / 0.3) ** 2)

    draws, accept = tpl.models.sample_hmc(logp, np.zeros(2), num_warmup=300, num_samples=500,
                                          num_chains=4, num_leapfrog=8, seed=11)
    assert draws.shape == (4, 500, 2)
    for j in range(2):
        x = draws[:, :, j]
        ess = float(ess_mean(x))
        got_mean, got_sd = x.mean(), x.std()
        assert abs(got_mean - mean[j]) < 4 * got_sd / math.sqrt(ess), (j, got_mean, mean[j], ess)
        assert abs(got_sd - sd[j]) < 4 * sd[j] / math.sqrt(2 * ess), (j, got_sd, sd[j], ess)
    _, want = jhmc.sample_hmc(lambda q: logp_j(q, y), np.zeros(2), num_warmup=300,
                              num_samples=500, num_chains=4, num_leapfrog=8, seed=11)
    assert abs(accept - want) < 0.02, (accept, want)


def logp_j(q, y):
    return (-0.5 * (q[0] / 10.0) ** 2 - 0.5 * jnp.sum((y - q[0]) ** 2)
            - 0.5 * ((q[1] - 0.5) / 0.3) ** 2)


def test_sample_hmc_takes_one_start_per_chain():
    jm, tm = MODELS["outlier"]()
    init = _draws(tm, n=3, scale=0.1)
    draws, _ = tpl.models.sample_hmc(tm.logp_flat, init, num_warmup=10, num_samples=5,
                                     num_leapfrog=2, seed=0)
    assert draws.shape == (3, 5, 2) and np.isfinite(draws).all()
    again, _ = tpl.models.sample_hmc(tm.logp_flat, init, num_warmup=10, num_samples=5,
                                     num_leapfrog=2, seed=0)
    assert_allclose(again, draws, rtol=0, atol=0)  # one generator, one seed


@pytest.mark.parametrize("name", ["eight_schools_noncentered", "roaches"])
def test_idata_from_flat_draws_matches_pyloo_tpu(name):
    jm, tm = MODELS[name]()
    flat = np.random.default_rng(4).normal(0.0, 0.3, size=(2, 6, jm.flat_dim))
    jid = jwrap.idata_from_flat_draws(jm, flat, accept=0.8)
    tid = twrap.idata_from_flat_draws(tm, flat, accept=0.8)
    assert sorted(tid.groups()) == sorted(jid.groups())
    for group in ("posterior", "sample_stats", "observed_data", "log_likelihood"):
        jds, tds = getattr(jid, group), getattr(tid, group)
        assert list(tds.data_vars) == list(jds.data_vars)
        for var in jds.data_vars:
            assert tds[var].dims == jds[var].dims
            assert_allclose(tds[var].values, jds[var].values, **F64)


def test_wrapper_matches_pyloo_tpu():
    jm, tm = MODELS["roaches"]()
    flat = np.random.default_rng(6).normal(0.0, 0.2, size=(2, 5, jm.flat_dim))
    jw = jpl.JAXModelWrapper(jm, jwrap.idata_from_flat_draws(jm, flat))
    tw = tpl.JAXModelWrapper(tm, twrap.idata_from_flat_draws(tm, flat))
    assert tw.get_variable_names() == jw.get_variable_names()
    assert tw.get_shapes() == jw.get_shapes()
    assert tw.get_observed_name() == jw.get_observed_name() == "y"
    assert_allclose(tw.get_unconstrained_parameters(), jw.get_unconstrained_parameters(),
                    rtol=0, atol=0)
    sel_t, rem_t = tw.select_observations([3, 7, 200])
    sel_j, rem_j = jw.select_observations([3, 7, 200])
    for k in sel_j:
        assert_allclose(sel_t[k], sel_j[k], rtol=0, atol=0)
        assert_allclose(rem_t[k], rem_j[k], rtol=0, atol=0)
    for holdout in ([3, 7, 200], sel_j):
        assert_allclose(tw.log_likelihood_i(holdout, tw.idata),
                        jw.log_likelihood_i(holdout, jw.idata), **F64)
    tw.set_data(rem_t)
    assert tw.n_obs == 259
    tw.reset_data()
    assert tw.n_obs == 262
    with pytest.raises(IndexError):
        tw.select_observations([262])
    with pytest.raises(TypeError, match="pyloo_tpu_torch Model"):
        tpl.JAXModelWrapper(jm)


def test_fit_assembles_an_idata_and_refuses_an_unknown_algorithm():
    """HMC's idata; a sampler that neither package has is refused."""
    jm, tm = MODELS["outlier"]()
    idata = tpl.models.fit(tm, draws=8, tune=8, chains=2, seed=1, num_leapfrog=2)
    assert idata.posterior["mu"].values.shape == (2, 8)
    assert idata.log_likelihood["obs"].values.shape == (2, 8, 30)
    assert idata.sample_stats["_flat_draws"].values.shape == (2, 8, 2)
    with pytest.raises(ValueError, match="Unknown algorithm"):
        tpl.models.fit(tm, algorithm="mala")


@pytest.mark.parametrize("algorithm", ["nuts", "chees"])
def test_fit_assembles_an_idata_for_each_algorithm(algorithm):
    """NUTS and ChEES through ``fit()`` (their parity:
    ``tests/test_torch_samplers.py``)."""
    _, tm = MODELS["outlier"]()
    idata = tpl.models.fit(tm, draws=4, tune=4, chains=2, seed=1, algorithm=algorithm)
    assert idata.posterior["mu"].values.shape == (2, 4)
    assert idata.log_likelihood["obs"].values.shape == (2, 4, 30)
    assert idata.sample_stats["_flat_draws"].values.shape == (2, 4, 2)
