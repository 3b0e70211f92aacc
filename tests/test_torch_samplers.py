"""``pyloo_tpu_torch``'s NUTS and ChEES samplers against ``pyloo_tpu``'s on the CPU.

One NUTS trajectory from the same start with the same draws: the proposal
and accept statistic within 1e-10, the tree depth and divergence equal.
Short runs of each sampler fed the draws ``jax.random`` makes for the same
seed (derived from ``pyloo_tpu``'s key chain): draws within 1e-9, tree
depths, divergences and step counts equal.  Longer runs on a conjugate
normal model find its posterior mean and sd within 4 MCSE.  ``fit()``'s
defaults and errors are ``pyloo_tpu``'s, and the host reads are counted.
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu_torch as tpl
from pyloo_tpu.models import chees as jchees
from pyloo_tpu.models import examples as jex
from pyloo_tpu.models import nuts as jnuts
from pyloo_tpu.models import wrapper as jwrap
from pyloo_tpu_torch.models import chees as tchees
from pyloo_tpu_torch.models import examples as tex
from pyloo_tpu_torch.models import hmc as thmc
from pyloo_tpu_torch.models import nuts as tnuts
from pyloo_tpu_torch.ops.ess import ess_mean

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


MODELS = {
    "eight_schools_noncentered": lambda: (
        jex.eight_schools_noncentered(), tex.eight_schools_noncentered()),
    "roaches": lambda: (jex.roaches_model(), tex.roaches_model()),
}


def _value_and_grad(tm):
    data = tm.tensor_data("cpu")
    return thmc._value_and_grad(lambda q: -tm.logp(tm.unravel(q), data))


def _nuts_tree_draws(step_key, D, max_depth):
    """The draws of one ``pyloo_tpu`` NUTS transition from its key
    (``nuts.py:79-80``, ``:105``, ``:138``, ``:210``): the momentum, and per
    doubling the direction and merge uniforms and the leaves' uniforms, a
    fixed function of (doubling, leaf) since a stopped leaf keeps its key."""
    k_mom, key = jax.random.split(step_key)
    dirs, merges, leaves = [], [], []
    for d in range(max_depth):
        key, k_dir, k_inner = jax.random.split(key, 3)
        dirs.append(jax.random.uniform(k_dir))
        sub = k_inner
        for _ in range(1 << d):
            sub, k_acc = jax.random.split(sub)
            leaves.append(jax.random.uniform(k_acc))
        key, k_acc = jax.random.split(key)
        merges.append(jax.random.uniform(k_acc))
    return jax.random.normal(k_mom, (D,)), jnp.stack(dirs), jnp.stack(merges), jnp.stack(leaves)


class _JaxDraws:
    """``nuts._GeneratorDraws``'s interface over ``jax.random``'s draws:
    arrays (C, steps, ...) from :func:`_nuts_tree_draws`."""

    def __init__(self, z, dirs, merges, leaves):
        self.z, self.dirs, self.merges, self.leaves = z, dirs, merges, leaves

    def momentum(self, t):
        return torch.from_numpy(self.z[:, t].copy())

    def doubling(self, t, d):
        return (torch.from_numpy(self.dirs[:, t, d].copy()),
                torch.from_numpy(self.merges[:, t, d].copy()))

    def leaf(self, t, d, m):
        return torch.from_numpy(self.leaves[:, t, (1 << d) - 1 + m].copy())


@pytest.mark.parametrize("name", list(MODELS))
def test_nuts_trajectory_matches_pyloo_tpu(name):
    """Five chains in one batch: a good step size, a small one, a large one,
    one so large it diverges and one so small it reaches max_depth."""
    jm, tm = MODELS[name]()
    D, max_depth = jm.flat_dim, 6
    scale = 1.0 if name == "eight_schools_noncentered" else 0.02
    eps = np.array([0.3, 0.05, 0.8, 20.0, 0.002]) * scale
    C = len(eps)
    rng = np.random.default_rng(0)
    q0 = rng.normal(0, 0.5 * scale, size=(C, D))
    inv_mass = rng.uniform(0.5, 1.5, size=(C, D))
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    pot = lambda q: -jm.logp_flat(q)  # noqa: E731
    one = jax.jit(jax.vmap(lambda q, e, m, k: jnuts._nuts_trajectory(
        pot, jax.grad(pot), q, e, m, k, max_depth)))
    want = list(zip(*(np.asarray(a) for a in one(q0, eps, inv_mass, keys))))
    z, dirs, merges, leaves = (np.asarray(a)[:, None] for a in jax.vmap(
        lambda k: _nuts_tree_draws(k, D, max_depth))(keys))
    vg = _value_and_grad(tm)
    q = torch.from_numpy(q0)
    potential, grad = vg(q)
    (q_prop, pot_prop, g_prop), accept, depth, diverged, doublings = tnuts._trajectory(
        vg, q, potential, grad, torch.from_numpy(eps), torch.from_numpy(inv_mass),
        _JaxDraws(z, dirs, merges, leaves), 0, max_depth)
    assert_allclose(q_prop.numpy(), np.stack([np.asarray(w[0]) for w in want]),
                    rtol=1e-10, atol=1e-10)
    assert_allclose(accept.numpy(), [float(w[1]) for w in want], rtol=1e-10, atol=1e-10)
    assert depth.tolist() == [int(w[2]) for w in want]
    assert diverged.tolist() == [bool(w[3]) for w in want]
    assert doublings == max(int(w[2]) for w in want)
    # the proposal carries its own potential and gradient
    v, g = vg(q_prop)
    assert_allclose(pot_prop.numpy(), v.numpy(), rtol=1e-12, atol=1e-12)
    assert_allclose(g_prop.numpy(), g.numpy(), rtol=1e-12, atol=1e-12)
    # both ends of the doubling loop are reached
    assert diverged[3] and (depth[4] == max_depth or name == "roaches")


def _init(seed, C, D):
    """``sample_nuts`` / ``sample_chees``'s jittered start and the key left."""
    key = jax.random.PRNGKey(seed)
    k_init, key = jax.random.split(key)
    return np.asarray(jax.random.normal(k_init, (C, D)) * 0.5), key


# target_accept 0.95: the step size stays small enough in 10 warmup steps for
# trees of depth 1 to 4 (seed 0) and some divergences (seed 1); at 0.8 every
# tree of these short runs has depth 1
@pytest.mark.parametrize("seed", [0, 1])
def test_nuts_run_with_jax_draws_matches_sample_nuts(seed):
    jm, tm = MODELS["eight_schools_noncentered"]()
    C, W, N, max_depth, D = 2, 10, 10, 4, jm.flat_dim
    want, want_acc, stats = jnuts.sample_nuts(
        jm.logp_flat, np.zeros(D), num_warmup=W, num_samples=N, num_chains=C,
        max_depth=max_depth, target_accept=0.95, seed=seed, full_stats=True)
    init_q, key = _init(seed, C, D)
    tree = jax.vmap(lambda k: _nuts_tree_draws(k, D, max_depth))
    z, dirs, merges, leaves = (np.asarray(a) for a in jax.vmap(
        lambda ck: tree(jax.random.split(ck, W + N)))(jax.random.split(key, C)))
    reads = []

    def counted(x):
        reads.append(1)
        return x.item()

    real = thmc._host_value
    thmc._host_value = counted
    try:
        got, acc, depth, div, doublings = tnuts._run_chains(
            _value_and_grad(tm), torch.from_numpy(init_q), _JaxDraws(z, dirs, merges, leaves),
            W, N, max_depth, 0.95)
    finally:
        thmc._host_value = real
    assert got.shape == (C, N, D)
    assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    assert_allclose(acc.numpy(), stats["accept_stat"], rtol=1e-9, atol=1e-9)
    assert_allclose(float(acc.mean()), want_acc, rtol=1e-9, atol=1e-9)
    assert (depth.numpy() == stats["tree_depth"]).all()
    assert (div.numpy() == stats["diverging"]).all()
    assert len(reads) == doublings >= W + N  # one host read a doubling
    assert len(set(stats["tree_depth"].ravel())) > 1 or stats["diverging"].any()


def test_chees_run_with_jax_draws_matches_sample_chees():
    jm, tm = MODELS["eight_schools_noncentered"]()
    C, W, N, L, seed, D = 4, 10, 10, 16, 5, jm.flat_dim
    want, want_acc = jchees.sample_chees(jm.logp_flat, np.zeros(D), num_warmup=W, num_samples=N,
                                         num_chains=C, max_leapfrog=L, seed=seed)
    init_q, key = _init(seed, C, D)
    want_steps = np.asarray(jchees._run(lambda q: -jm.logp_flat(q), jnp.asarray(init_q), key, W,
                                        N, L, 0.75, 0.2)[2])

    def per_step(k):  # chees.py:94, :110, :113, :121
        k_mom, k_acc, k_eps = jax.random.split(k, 3)
        return (jax.random.normal(k_mom, (C, D)), jax.random.uniform(k_eps, (C,)),
                jax.random.uniform(k_acc, (C,)))

    z, u_eps, u_acc = (np.asarray(a) for a in jax.vmap(per_step)(jax.random.split(key, W + N)))
    reads = []

    def counted(x):
        reads.append(1)
        return x.item()

    real = thmc._host_value
    thmc._host_value = counted
    try:
        got, acc, steps = tchees._run_chains(
            _value_and_grad(tm), torch.from_numpy(init_q),
            lambda t: (torch.from_numpy(z[t].copy()), torch.from_numpy(u_eps[t].copy()),
                       torch.from_numpy(u_acc[t].copy())),
            W, N, L, 0.75, 0.2)
    finally:
        thmc._host_value = real
    assert got.shape == (C, N, D)
    assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    assert_allclose(float(acc.mean()), want_acc, rtol=1e-9, atol=1e-9)
    assert steps[W:] == want_steps.tolist() and len(set(steps)) > 1
    assert len(reads) == W + N  # one host read an iteration


def _conjugate():
    """y_i ~ N(mu, 1), mu ~ N(0, 10^2); log_s ~ N(0.5, 0.3^2): the posterior
    of ``tests/test_torch_models.py``'s conjugate test, known exactly."""
    y = np.random.default_rng(5).normal(1.5, 1.0, size=25)
    prec = len(y) + 1 / 100.0
    mean = np.array([y.sum() / prec, 0.5])
    sd = np.array([prec**-0.5, 0.3])
    yt = torch.from_numpy(y)

    def logp(q):
        return (-0.5 * (q[0] / 10.0) ** 2 - 0.5 * torch.sum((yt - q[0]) ** 2)
                - 0.5 * ((q[1] - 0.5) / 0.3) ** 2)

    return logp, mean, sd


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_sampler_finds_a_conjugate_posterior(sampler):
    logp, mean, sd = _conjugate()
    if sampler == "nuts":
        draws, accept, stats = tpl.models.sample_nuts(
            logp, np.zeros(2), num_warmup=200, num_samples=400, num_chains=4, seed=11,
            full_stats=True)
        assert stats["tree_depth"].shape == (4, 400) and stats["tree_depth"].dtype == np.int32
        assert stats["diverging"].dtype == bool and not stats["diverging"].any()
        assert_allclose(stats["accept_stat"].mean(), accept, rtol=1e-12)
    else:
        draws, accept = tchees.sample_chees(logp, np.zeros(2), num_warmup=200, num_samples=400,
                                            num_chains=8, seed=11)
    assert draws.shape[1:] == (400, 2) and 0.3 < accept <= 1.0
    for j in range(2):
        x = draws[:, :, j]
        ess = float(ess_mean(x))
        got_mean, got_sd = x.mean(), x.std()
        assert abs(got_mean - mean[j]) < 4 * got_sd / math.sqrt(ess), (j, got_mean, mean[j], ess)
        assert abs(got_sd - sd[j]) < 4 * sd[j] / math.sqrt(2 * ess), (j, got_sd, sd[j], ess)


def test_fit_defaults_and_errors_match_pyloo_tpu():
    """``tests/test_samplers.py:244`` and ``tests/test_variational.py:168`` on the port."""
    jm, tm = MODELS["eight_schools_noncentered"]()
    for algorithm, chains in (("chees", 16), ("hmc", 4), ("nuts", 4)):
        idata = tpl.models.fit(tm, draws=5, tune=6, seed=3, algorithm=algorithm)
        assert idata.posterior["mu"].values.shape == (chains, 5)
        assert np.isfinite(idata.log_likelihood["obs"].values).all()
    with pytest.raises(ValueError, match="Unknown algorithm"):
        tpl.models.fit(tm, algorithm="slice")
    with pytest.raises(ValueError, match="Unknown algorithm"):
        jwrap.fit(jm, algorithm="slice")
    for bad in (0, 31):
        with pytest.raises(ValueError, match="max_depth"):
            tnuts.sample_nuts(tm.logp_flat, np.zeros(tm.flat_dim), max_depth=bad)
    with pytest.raises(ValueError, match="step_size_jitter"):
        tchees.sample_chees(tm.logp_flat, np.zeros(tm.flat_dim), step_size_jitter=1.0)
    for mod_j, mod_t, name in ((jchees, tchees, "sample_chees"), (jnuts, tnuts, "sample_nuts")):
        want = inspect.signature(getattr(mod_j, name)).parameters
        got = inspect.signature(getattr(mod_t, name)).parameters
        assert {k: p.default for k, p in got.items()} == {k: p.default for k, p in want.items()}
    assert "sample_chees" not in tpl.models.__all__ and "sample_nuts" in tpl.models.__all__


def test_samplers_take_one_start_per_chain_and_repeat_for_a_seed():
    _, tm = MODELS["eight_schools_noncentered"]()
    init = np.random.default_rng(0).normal(0, 0.1, size=(3, tm.flat_dim))
    for sample in (tnuts.sample_nuts, tchees.sample_chees):
        kw = dict(num_warmup=6, num_samples=4, seed=2)
        a, _ = sample(tm.logp_flat, init, **kw)
        b, _ = sample(tm.logp_flat, init, **kw)
        assert a.shape == (3, 4, tm.flat_dim) and np.isfinite(a).all()
        assert_allclose(a, b, rtol=0, atol=0)


def test_kfold_with_nuts_refits_through_the_serial_loop(monkeypatch):
    """``algorithm="nuts"`` is not the batched program's: each fold refits
    through ``fit`` (``loo_kfold.py:197`` in ``pyloo_tpu``)."""
    import sys

    kfold_mod = sys.modules["pyloo_tpu_torch.loo_kfold"]

    def refuse(*args, **kwargs):
        raise AssertionError("the batched fold program ran")

    monkeypatch.setattr(kfold_mod, "kfold_refit_batched", refuse)
    # fixed parameter shapes and equal folds: with HMC this would be batched
    y = np.random.default_rng(2).normal(1.0, 1.0, size=12)

    def log_lik(p, d):
        return -0.5 * math.log(2 * math.pi) - 0.5 * (d["y"] - p["mu"]) ** 2

    def logp(p, d):
        return -0.5 * (p["mu"] / 10.0) ** 2 + torch.sum(log_lik(p, d))

    tm = tpl.Model("normal", {"y": y}, {"mu": ()}, logp, log_lik, obs_keys=("y",))
    opts = dict(draws=8, tune=8, chains=2, algorithm="nuts", max_depth=3, seed=0)
    idata = tpl.models.fit(tm, **opts)
    wrapper = tpl.JAXModelWrapper(tm, idata, sample_kwargs=opts)
    res = tpl.loo_kfold(wrapper, K=2, random_seed=0, pointwise=True)
    assert res["K"] == 2 and np.isfinite(res.kfold_i.values).all()
