"""The last public names of ``pyloo_tpu`` in the port, each held to
``pyloo_tpu``: the ``utils`` shims of the reference API (``reshape_draws``,
``make_ufunc``, ``wrap_xarray_ufunc``), the six functions ``ops`` re-exports,
and the attributes a plain ``loo()`` result reads by default.  The shim
cases mirror ``tests/test_substrate.py`` (``TestUfuncShims``) and
``tests/test_edges.py`` (``TestReshapeDraws``)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu import ops as jops
from pyloo_tpu import utils as jutils
from pyloo_tpu.containers import DataArray as JDataArray
from pyloo_tpu_torch import ops as tops
from pyloo_tpu_torch import utils as tutils
from pyloo_tpu_torch.containers import DataArray as TDataArray

from .torch_parity import F64, eight, synthetic


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


@pytest.fixture
def rng():
    return np.random.default_rng(12)


def test_make_ufunc_loops_observations(rng):
    x = rng.normal(size=(5, 20))
    f = tutils.make_ufunc(lambda row: row.sum(), n_dims=1)
    assert_allclose(f(x), x.sum(axis=1))
    assert_array_equal(f(x), jutils.make_ufunc(lambda row: row.sum(), n_dims=1)(x))
    two = lambda row: (row.min(), row.max())  # noqa: E731
    lo, hi = tutils.make_ufunc(two, n_output=2, n_dims=1)(x)
    jlo, jhi = jutils.make_ufunc(two, n_output=2, n_dims=1)(x)
    assert_allclose(lo, x.min(axis=1))
    assert_allclose(hi, x.max(axis=1))
    assert_array_equal(lo, jlo)
    assert_array_equal(hi, jhi)
    # two inputs, an extra argument, no ravel, empty leading dimensions
    y = rng.normal(size=(5, 20))
    both = lambda a, b, c: (a * b).sum() + c  # noqa: E731
    got = tutils.make_ufunc(both, n_input=2, ravel=False)(x, y, 1.5)
    assert_array_equal(got, jutils.make_ufunc(both, n_input=2, ravel=False)(x, y, 1.5))
    empty = np.zeros((0, 20))
    assert tutils.make_ufunc(np.sum)(empty).shape == jutils.make_ufunc(np.sum)(empty).shape


@pytest.mark.parametrize("n_output", [1, 2])
def test_wrap_xarray_ufunc(rng, n_output):
    values = rng.normal(size=(4, 30))
    fn = (lambda row: row.mean()) if n_output == 1 else (lambda row: (row.mean(), row.std()))
    kw = dict(input_core_dims=[["__sample__"]], ufunc_kwargs={"n_output": n_output})
    got = tutils.wrap_xarray_ufunc(fn, TDataArray(values, ("obs", "__sample__")), **kw)
    want = jutils.wrap_xarray_ufunc(fn, JDataArray(values, ("obs", "__sample__")), **kw)
    got, want = (got, want) if n_output == 2 else ((got,), (want,))
    for g, w in zip(got, want, strict=True):
        assert isinstance(g, TDataArray)
        assert g.dims == w.dims == ("obs",)
        assert_array_equal(g.values, w.values)
    assert_allclose(got[0].values, values.mean(axis=1))
    # a plain array in, a plain array out
    plain = tutils.wrap_xarray_ufunc(lambda row: row.max(), values)
    assert_array_equal(plain, jutils.wrap_xarray_ufunc(lambda row: row.max(), values))


def test_reshape_draws_roundtrip(rng):
    x = rng.normal(size=(10, 4, 3))
    flat, ids = tutils.reshape_draws(x)
    assert flat.shape == (40, 3)
    assert ids is None
    chain_ids = np.repeat(np.arange(4), 10)
    back, ids2 = tutils.reshape_draws(flat, chain_ids)
    assert back.shape == (10, 4, 3)
    jback, jids = jutils.reshape_draws(jutils.reshape_draws(x)[0], chain_ids)
    assert_array_equal(back, jback)
    assert_array_equal(ids2, jids)
    assert tutils.reshape_draws(flat)[0] is flat  # 2-D without chain ids: unchanged


def test_ops_reexports_match_pyloo_tpu(rng):
    names = ("gpdfit", "gpinv", "ess_mean", "relative_eff", "compact_weighted_mean",
             "compact_weighted_moments")
    assert all(name in tops.__all__ and hasattr(tops, name) for name in names)
    tail = np.sort(rng.pareto(3.0, size=(3, 80)), axis=1) + 1e-3
    k, sigma = tops.gpdfit(torch.from_numpy(tail))
    jk, jsigma = jops.gpdfit(jnp.asarray(tail))
    assert_allclose(k.numpy(), np.asarray(jk), **F64)
    assert_allclose(sigma.numpy(), np.asarray(jsigma), **F64)
    probs = np.array([0.0, 0.1, 0.5, 0.9, 1.0])
    for kappa, scale in ((0.3, 1.2), (-0.4, 0.8), (0.0, 1.0)):
        assert_allclose(tops.gpinv(torch.from_numpy(probs), kappa, scale).numpy(),
                        np.asarray(jops.gpinv(jnp.asarray(probs), kappa, scale)), **F64)
    chains = rng.normal(size=(4, 200)).cumsum(axis=1) * 0.1 + rng.normal(size=(4, 200))
    assert_allclose(tops.ess_mean(chains), jops.ess_mean(chains), **F64)
    post = {"a": rng.normal(size=(4, 200)), "b": rng.normal(size=(4, 200, 3))}
    assert_allclose(tops.relative_eff(post, 800), jops.relative_eff(post, 800), **F64)
    lw = rng.normal(size=(6, 400))
    h = rng.normal(size=(6, 400))
    m = tops.tail_length(400)
    compact = tops.psislw_compact_batch(torch.from_numpy(lw), m)
    jcompact = jops.psislw_compact_batch(jnp.asarray(lw), m)
    mean = tops.compact_weighted_mean(torch.from_numpy(h), torch.from_numpy(lw), *compact[:4])
    jmean = jops.compact_weighted_mean(jnp.asarray(h), jnp.asarray(lw), *jcompact[:4])
    assert_allclose(mean.numpy(), np.asarray(jmean), **F64)
    moments = tops.compact_weighted_moments(torch.from_numpy(h), torch.from_numpy(lw),
                                            *compact[:4])
    jmoments = jops.compact_weighted_moments(jnp.asarray(h), jnp.asarray(lw), *jcompact[:4])
    for g, w in zip(moments, jmoments, strict=True):
        assert_allclose(g.numpy(), np.asarray(w), **F64)


def test_elpd_data_defaults_match_pyloo_tpu():
    jid, tid = eight()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, want = tpl.loo(tid, pointwise=True), jpl.loo(jid, pointwise=True)
    for name in ("n_groups", "method", "K", "stratified"):
        assert getattr(got, name) == getattr(want, name), name
    assert (got.n_groups, got.method, got.K, got.stratified) == (None, "psis", None, False)
    got.method = "kfold"  # what another kind sets wins over the default
    assert got.method == "kfold"
    with pytest.raises(AttributeError):
        got.no_such_attribute
    jg, tg = synthetic(obs_shape=(12,))
    groups = np.arange(12) // 3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tpl.loo_group(tg, groups).n_groups == jpl.loo_group(jg, groups).n_groups == 4
